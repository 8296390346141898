"""Multi-host encode: process wiring + per-process data feeding.

The reference is strictly single-process (SURVEY.md §2: no MPI/NCCL/
sockets). This framework scales the same shard_map program from one chip to
a multi-host cluster: the mesh spans all processes' devices, XLA routes the
psum'd histograms and the ppermute DC hand-off over the intra-host links
and the network across hosts, and (multi-process only) one all_gather replicates the
per-shard COMPRESSED segments so process 0 can assemble the JPEG
(parallel/sharding.py).

Data plumbing: each process supplies only ITS OWN image rows.
`local_row_range` says which rows of the original image a process must
load; `encode_array_distributed` pads them into the process-local slab,
builds the global device array with `jax.make_array_from_process_local_data`,
dispatches the ONE-program sharded encode, and assembles the JPEG on
process 0 (returns None elsewhere). The bytes are identical to a
single-process `encode_array` of the whole image (tested in
tests/test_multihost.py with two real jax.distributed CPU processes).

Typical multi-host driver (same script on every host):

    from dmmt_jpeg_encoder.parallel import multihost as mh
    mh.initialize_distributed(coordinator, num_processes, process_id)
    config = EncoderConfig(num_shards=mh.global_mesh_shards(),
                           scan_backend="device")
    r0, r1 = mh.local_row_range(height, width, config)
    jpeg = mh.encode_array_distributed(
        load_rows(r0, r1), height, width, 255, config,
    )  # bytes on process 0, None elsewhere
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize with explicit or env-provided topology.

    No-op when already initialized (or single-process)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized — keep going
        pass
    except ValueError:
        # no coordinator given and no cluster autodetection available:
        # plain single-process run, nothing to wire up
        if coordinator_address is not None:
            raise


def global_mesh_shards() -> int:
    """Number of shards for a whole-slice mesh (= all global devices)."""
    return len(jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0


def _distributed_geometry(height: int, width: int, config):
    """Shared geometry: (ph, pw, slab_rows per shard, shards per process)."""
    from .sharding import _shard_geometry

    preset = config.chroma_subsampling
    n = config.num_shards
    n_proc = jax.process_count()
    if n % n_proc:
        raise ValueError(
            f"num_shards={n} must be divisible by process_count={n_proc}"
        )
    ph, pw, rows_per_shard, _ = _shard_geometry(height, width, preset, n)
    slab = rows_per_shard * preset.mcu_height
    return ph, pw, slab, n // n_proc


def local_row_range(height: int, width: int, config) -> tuple[int, int]:
    """Rows [r0, r1) of the ORIGINAL image this process must supply to
    encode_array_distributed. r1 is clamped to the image height: rows
    beyond it are padding this process generates itself (black, matching
    the reference's padder — padder.rs:16), so a process whose shards are
    entirely alignment padding loads nothing."""
    ph, pw, slab, shards_per_proc = _distributed_geometry(
        height, width, config
    )
    pid = jax.process_index()
    r0 = pid * shards_per_proc * slab
    r1 = (pid + 1) * shards_per_proc * slab
    return min(r0, height), min(r1, height)


def encode_array_distributed(
    local_pixels: "np.ndarray | None",
    height: int,
    width: int,
    maxval: int,
    config,
    input_dtype=None,
) -> bytes | None:
    """Multi-process encode from process-local image rows.

    local_pixels: this process's rows of the original image (see
    local_row_range), [r1-r0, width, 3] uint8/uint16 — or None when the
    range is empty. Every process participates in the device program;
    only process 0 assembles and returns the JPEG bytes.

    input_dtype: the IMAGE dtype, required when local_pixels is None in a
    multi-process run — every process must trace the identical program
    (multi-controller JAX), so a process with no rows cannot guess the
    dtype its peers are feeding.

    SPMD discipline: all processes must call this with the same image
    sequence — the finish step's speculative-fetch decisions are derived
    from per-geometry history and must match across processes.

    Requires the one-dispatch sharded path: the two-dispatch path's host
    tail would need the per-shard coefficient arrays, which are not
    addressable cross-process.
    """
    from ..container import assemble_jpeg
    from ..tables import quantization_table_pair
    from .sharding import (
        _compiled_sharded_onedispatch,
        _finish_sharded_onedispatch,
        _use_sharded_onedispatch,
    )

    if not _use_sharded_onedispatch(config, height, width):
        raise NotImplementedError(
            "multi-process encode requires the one-dispatch sharded path "
            "(image within the device table build's exactness bound)"
        )
    preset = config.chroma_subsampling
    ph, pw, slab, shards_per_proc = _distributed_geometry(
        height, width, config
    )
    pid = jax.process_index()
    r0 = pid * shards_per_proc * slab

    # Process-local slab of the global PADDED image: place the local rows,
    # black-pad the rest (right pad + bottom/alignment rows).
    local_h = shards_per_proc * slab
    if local_pixels is not None:
        dtype = np.asarray(local_pixels).dtype
        if input_dtype is not None and np.dtype(input_dtype) != dtype:
            raise ValueError(
                f"input_dtype={np.dtype(input_dtype)} contradicts "
                f"local_pixels.dtype={dtype}"
            )
    elif input_dtype is not None:
        dtype = np.dtype(input_dtype)
    elif jax.process_count() == 1:
        dtype = np.dtype(np.uint8)
    else:
        raise ValueError(
            "a process with no local rows must pass input_dtype: all "
            "processes have to trace the identical program"
        )
    slab_px = np.zeros((local_h, pw, 3), dtype=dtype)
    if local_pixels is not None and len(local_pixels):
        lp = np.asarray(local_pixels)
        slab_px[: lp.shape[0], : lp.shape[1]] = lp

    fn, mesh, geom = _compiled_sharded_onedispatch(
        height, width, preset, config.dct_variant, config.num_shards,
        gather=True,
    )
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("mcu_rows", None, None)),
        slab_px,
        (ph, pw, 3),
    )
    luma_q, chroma_q = quantization_table_pair(
        config.quantization_preset, config.quality
    )
    outputs = fn(
        garr, jnp.float32(maxval), jnp.asarray(luma_q), jnp.asarray(chroma_q)
    )
    scan, tables = _finish_sharded_onedispatch(
        ("onedispatch", outputs, geom, (height, width)), config
    )
    if pid != 0:
        return None
    return assemble_jpeg(
        width=width,
        height=height,
        bits_per_channel=config.bits_per_channel,
        preset=preset,
        luma_quant=luma_q,
        chroma_quant=chroma_q,
        luma_dc=tables.luma_dc,
        luma_ac=tables.luma_ac,
        chroma_dc=tables.chroma_dc,
        chroma_ac=tables.chroma_ac,
        scan_bytes=scan,
    )


def scaling_report(mpix_per_s_one_chip: float, mpix_per_s_n_chips: float,
                   n_chips: int) -> dict:
    """Scaling-efficiency summary for the >=80% multi-host target
    (BASELINE.md)."""
    ideal = mpix_per_s_one_chip * n_chips
    eff = mpix_per_s_n_chips / ideal if ideal else 0.0
    return {
        "chips": n_chips,
        "throughput_mpix_s": round(mpix_per_s_n_chips, 2),
        "ideal_mpix_s": round(ideal, 2),
        "scaling_efficiency": round(eff, 4),
    }
