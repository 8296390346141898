"""Backend selection and mode-keyed program caches.

- ``on_accelerator()``: the one backend question the encoder asks — is
  the default JAX backend an accelerator (anything but the CPU)? It picks
  the scan backend when ``EncoderConfig.scan_backend == "auto"``.
- ``trace_mode_key()`` / ``mode_keyed_cache``: environment modes that get
  baked into traced programs, and an ``lru_cache`` that keys on them.
"""

from __future__ import annotations

import functools
import os
from functools import lru_cache

import jax

__all__ = [
    "mode_keyed_cache",
    "on_accelerator",
    "resolve_scan_backend",
    "trace_mode_key",
]


def on_accelerator() -> bool:
    """True when the default JAX backend is not the CPU."""
    return jax.default_backend() != "cpu"


def resolve_scan_backend(scan_backend: str) -> str:
    """"auto" -> "device" on an accelerator, "host" (C packer) on the CPU;
    explicit choices pass through."""
    if scan_backend == "auto":
        return "device" if on_accelerator() else "host"
    return scan_backend


def trace_mode_key() -> tuple:
    """Everything from the environment that gets BAKED INTO a traced
    program: the phase-1 layout mode and the timing-only table ablation.
    Any lru_cache holding a jitted program must include this in its key,
    or an env toggle after the first compile at a given geometry is
    silently ignored."""
    return (
        os.environ.get("DMMT_P1", "plane"),
        bool(os.environ.get("DMMT_TABLE_ABLATE")),
    )


def mode_keyed_cache(maxsize: int):
    """``lru_cache`` whose key silently includes ``trace_mode_key()``.

    Every cached jitted-program builder must key on the env modes baked
    into the trace; decorating the builder once keeps that from rotting."""

    def deco(fn):
        @lru_cache(maxsize=maxsize)
        def keyed(_mode, *args, **kw):
            return fn(*args, **kw)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            return keyed(trace_mode_key(), *args, **kw)

        wrapper.cache_clear = keyed.cache_clear
        return wrapper

    return deco
