"""chip_smoke.py on the CPU: its phase functions at tiny sizes (with the
CPU standing in for the GPU in the scan-backend choice) and its exit
contract when no GPU is present."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke
from dmmt_jpeg_encoder.utils import capability

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def device_backend(monkeypatch):
    """scan_backend="auto" picks the device packer, as on a GPU."""
    monkeypatch.setattr(capability, "on_accelerator", lambda: True)
    monkeypatch.setenv("DMMT_CHECK_BITS", "1")
    yield
    jax.clear_caches()


def test_main_without_gpu_exits_nonzero_and_prints_no_result(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_device_compiles_tiny_program(device_backend):
    secs = chip_smoke.phase_device(sizes=((16, 32),))
    assert set(secs) == {(16, 32)}


def test_phase_parity_tiny(device_backend):
    keys = ["8x8|P420|Specification|arai", "7x17|P444|Flat|fused"]
    report = chip_smoke.phase_parity(
        frames=((40, 56),), keys=keys, variant_size=(32, 48),
        psnr_size=(32, 48),
    )
    assert report["corpus"] == {"arai": 1, "fused": 1}
    assert report["fused"] == 0 and report["separated"] == 0


def test_phase_cli_tiny(device_backend, tmp_path):
    chip_smoke.phase_cli(size=(24, 40), workdir=str(tmp_path))


def test_phase_batch_tiny_runs_slab(device_backend):
    out = chip_smoke.phase_batch(
        frame_size=(32, 48), n_frames=2, tile=16, n_tiles=4
    )
    assert sum(out["slab_depths"]) == 4


def test_phase_numbers_tiny(device_backend, capsys):
    batch = chip_smoke.phase_batch(
        frame_size=(32, 48), n_frames=2, tile=16, n_tiles=3
    )
    chip_smoke.phase_numbers("test card, 1.00 W", batch, size=(32, 48))
    out = capsys.readouterr().out
    assert "[test card, 1.00 W] histogram matmul (kept)" in out
    assert "[test card, 1.00 W] histogram scatter" in out


def test_phase_multi_tiny(device_backend):
    chip_smoke.phase_multi(n_shards=4, size=(48, 40), n_frames=2)


def test_unrounded_reference_rounds_to_the_pipeline(device_backend):
    """The float64 pre-rounding reference used for the .5-boundary check
    rounds to the CPU pipeline's SEPARATED coefficients everywhere except
    at .5 boundaries."""
    from dmmt_jpeg_encoder.config import (
        ChromaSubsamplingPreset,
        DCTVariant,
        EncoderConfig,
    )
    from dmmt_jpeg_encoder.debug.seeded_corpus import seeded_frame

    cfg = EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset.P444,
        dct_variant=DCTVariant.SEPARATED,
    )
    px = seeded_frame(40, 56, seed=3)
    got = [chip_smoke.undo_dpcm(a) for a in chip_smoke.coefficients(px, cfg)]
    for g, ref in zip(got, chip_smoke.unrounded_p444(px, cfg)):
        want = np.sign(ref) * np.floor(np.abs(ref) + 0.5)
        d = np.nonzero(g != want)
        v = np.abs(ref[d])
        assert np.all(np.abs(v - np.floor(v) - 0.5) < chip_smoke.HALF_STEP_EPS)


def test_contract_line_shape():
    """The success line chip_smoke prints last is one JSON object with
    the device keys the runner reads."""
    line = json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": "k", "count": 1}}
    )
    obj = json.loads(line)
    assert set(obj["device"]) == {"platform", "kind", "count"}
