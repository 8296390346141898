"""Multi-host wiring: initialize_distributed, global mesh, scaling report.

Real multi-host cannot run here; this exercises the wiring end to end in
single-process form — the no-op path in-process (jax is already
initialized by conftest) and a REAL jax.distributed service in a
subprocess where initialization happens before the backend comes up.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from dmmt_jpeg_encoder.parallel.multihost import (
    global_mesh_shards,
    initialize_distributed,
    is_coordinator,
    scaling_report,
)

REPO = Path(__file__).resolve().parent.parent


def test_initialize_is_noop_after_backend_init():
    # jax is already live (conftest): initialize must swallow the failure
    # and leave the process usable.
    initialize_distributed()
    assert global_mesh_shards() == len(jax.devices()) == 8
    assert is_coordinator()


def test_scaling_report_values():
    rep = scaling_report(100.0, 640.0, 8)
    assert rep["chips"] == 8
    assert rep["ideal_mpix_s"] == 800.0
    assert rep["scaling_efficiency"] == 0.8
    assert scaling_report(0.0, 10.0, 2)["scaling_efficiency"] == 0.0


def test_real_distributed_init_single_process_encode():
    """Subprocess: real jax.distributed service, global mesh over 8 virtual
    devices, sharded encode through global_mesh_shards() — byte-identical
    to the single-shard encode."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
from dmmt_jpeg_encoder.parallel.multihost import (
    initialize_distributed, global_mesh_shards, is_coordinator,
)
initialize_distributed("localhost:{port}", 1, 0)
assert jax.process_count() == 1
assert is_coordinator()
n = global_mesh_shards()
assert n == 8, n
import numpy as np
from dmmt_jpeg_encoder import encode_array
from dmmt_jpeg_encoder.config import EncoderConfig, ChromaSubsamplingPreset
rng = np.random.default_rng(3)
px = rng.integers(0, 256, (44, 28, 3), dtype=np.uint16)
preset = ChromaSubsamplingPreset.P420
sharded = encode_array(px, 255, EncoderConfig(
    chroma_subsampling=preset, num_shards=n, scan_backend="device"))
single = encode_array(px, 255, EncoderConfig(chroma_subsampling=preset))
assert sharded == single, "sharded bytes diverge under jax.distributed"
print("DISTRIBUTED_OK", len(sharded))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["DMMT_CHECK_BITS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DISTRIBUTED_OK" in proc.stdout


_TWO_PROC_WORKER = """
import os, sys
port, pid, out_path, h, w = sys.argv[1:6]
h, w = int(h), int(w)
os.environ["DMMT_CHECK_BITS"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", 2, int(pid))
assert jax.process_count() == 2
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4
import numpy as np
from dmmt_jpeg_encoder.config import ChromaSubsamplingPreset, EncoderConfig
from dmmt_jpeg_encoder.parallel import multihost as mh

# Deterministic image, regenerated identically in each process; each
# process then KEEPS ONLY ITS OWN ROWS (per-process data feeding).
rng = np.random.default_rng(1234)
pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
cfg = EncoderConfig(
    chroma_subsampling=ChromaSubsamplingPreset.P420,
    num_shards=8, scan_backend="device",
)
r0, r1 = mh.local_row_range(h, w, cfg)
local = pixels[r0:r1] if r1 > r0 else None
jpeg = mh.encode_array_distributed(local, h, w, 255, cfg,
                                   input_dtype=pixels.dtype)
if jax.process_index() == 0:
    assert jpeg is not None
    with open(out_path, "wb") as f:
        f.write(jpeg)
else:
    assert jpeg is None, "only process 0 assembles the JPEG"
print("WORKER_DONE", jax.process_index())
"""


def _run_two_process_encode(tmp_path, h, w):
    """Launch 2 real jax.distributed CPU processes (4+4 virtual devices),
    each feeding only its own image rows; return process 0's JPEG."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_TWO_PROC_WORKER)
    out_path = tmp_path / f"out_{h}x{w}.jpg"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(i), str(out_path),
             str(h), str(w)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{se[-3000:]}"
        assert f"WORKER_DONE {i}" in so
    return out_path.read_bytes()


def test_two_process_distributed_encode_bit_exact(tmp_path):
    """VERDICT r2 #5: two jax.distributed processes, 4+4 virtual CPU
    devices, per-process input shards via make_array_from_process_local_data,
    JPEG assembled on process 0 only — byte-equal to single-process."""
    h, w = 128, 48  # 8 MCU rows: one per shard, both processes feed rows
    jpeg = _run_two_process_encode(tmp_path, h, w)

    from dmmt_jpeg_encoder import encode_array
    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        EncoderConfig,
    )

    rng = np.random.default_rng(1234)
    pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
    single = encode_array(
        pixels, 255,
        EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420),
    )
    assert jpeg == single, "2-process bytes diverge from single-process"


def test_two_process_distributed_encode_empty_second_process(tmp_path):
    """Non-divisible image (3 MCU rows over 8 shards): process 1's shards
    are pure alignment padding, it loads zero rows, and the bytes still
    match the single-process encode."""
    h, w = 44, 28
    jpeg = _run_two_process_encode(tmp_path, h, w)

    from dmmt_jpeg_encoder import encode_array
    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        EncoderConfig,
    )

    rng = np.random.default_rng(1234)
    pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
    single = encode_array(
        pixels, 255,
        EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P420),
    )
    assert jpeg == single


def test_encode_array_distributed_single_process():
    """The distributed entry point also runs single-process on the local
    8-device mesh (process_count=1), byte-equal to encode_array."""
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from dmmt_jpeg_encoder import encode_array
    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        EncoderConfig,
    )
    from dmmt_jpeg_encoder.parallel import multihost as mh

    rng = np.random.default_rng(7)
    h, w = 64, 48
    pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint16)
    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P444,
        num_shards=8, scan_backend="device",
    )
    r0, r1 = mh.local_row_range(h, w, cfg)
    assert (r0, r1) == (0, h)  # one process: all rows are local
    jpeg = mh.encode_array_distributed(pixels[r0:r1], h, w, 255, cfg)
    single = encode_array(
        pixels, 255,
        EncoderConfig(chroma_subsampling=ChromaSubsamplingPreset.P444),
    )
    assert jpeg == single
