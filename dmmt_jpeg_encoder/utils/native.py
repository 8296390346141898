"""Build-and-load for the native C helpers.

The reference is 100% native code; in this framework the device compute path
is JAX/XLA and the host runtime's serial hot loops (scan bit-packing,
ASCII PPM parsing) are native C, compiled once on first use and cached in
``<repo>/.native_build`` (``DMMT_JPEG_CACHE`` overrides). Pure-Python fallbacks exist for every native entry point, so
the framework degrades gracefully when no C toolchain is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "bitstream" / "csrc"
_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / ".native_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def _cache_dir() -> Path:
    d = os.environ.get("DMMT_JPEG_CACHE")
    if d:
        path = Path(d)
    else:
        path = _DEFAULT_CACHE
    path.mkdir(parents=True, exist_ok=True)
    return path


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.c"))


def _build(sources: list[Path], out: Path) -> None:
    cc = os.environ.get("CC", "cc")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        cc,
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c11",
        "-pthread",
        "-o",
        str(tmp),
        *[str(s) for s in sources],
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    # atomic publish: concurrent processes never load a half-written file
    os.replace(tmp, out)


def load_native() -> ctypes.CDLL | None:
    """Return the native helper library, building it if needed; None if
    building fails (callers fall back to Python implementations)."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("DMMT_JPEG_NO_NATIVE"):
            _LIB_FAILED = True
            return None
        sources = _sources()
        if not sources:
            _LIB_FAILED = True
            return None
        digest = hashlib.sha256(
            b"".join(s.read_bytes() for s in sources)
        ).hexdigest()[:16]
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        out = _cache_dir() / f"dmmt_native_{digest}{suffix}"
        try:
            if not out.exists():
                _build(sources, out)
            _LIB = ctypes.CDLL(str(out))
        except Exception:
            _LIB_FAILED = True
            return None
        return _LIB
