"""Structured segment hexdump logging.

The reference logs every JPEG segment (marker, length, full hex content) via
log4rs (reference: src/logger.rs:7-17, call site src/...jpeg/encoder.rs:148),
which doubles as a built-in bitstream inspector. We keep that capability via
the stdlib logging module: enable with configure_logging() or by setting
DMMT_JPEG_LOG=<path or 'stderr'>.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("dmmt_jpeg_encoder")
_configured = False


def configure_logging(target: str | None = None, level: int = logging.INFO) -> None:
    """Attach a file/stderr handler once (log4rs.yaml equivalent)."""
    global _configured
    if _configured:
        return
    target = target or os.environ.get("DMMT_JPEG_LOG")
    if not target:
        return
    if target == "stderr":
        handler: logging.Handler = logging.StreamHandler()
    else:
        handler = logging.FileHandler(target)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s - %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
    _configured = True


def _hex(data: bytes) -> str:
    return "[" + ", ".join(f"{b:02X}" for b in data) + "]"


def log_segment(marker: bytes, content: bytes, segment_length: bytes) -> None:
    """Hexdump one segment (reference: src/logger.rs:7-17)."""
    if logger.isEnabledFor(logging.INFO):
        logger.info("%s %s\n%s", _hex(marker), _hex(segment_length), _hex(content))
