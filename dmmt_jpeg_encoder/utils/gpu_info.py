"""The GPU's name and power limit, as nvidia-smi reports them.

A card capped below its maximum power runs slower under load, so every
timing this repository prints carries this line."""

from __future__ import annotations

import subprocess


def card_lines() -> list[str]:
    """One "name, power.limit" line per visible GPU, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"; [] when nvidia-smi is unavailable."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def card_label() -> str:
    """The first card's line, or "unknown card" without nvidia-smi."""
    lines = card_lines()
    return lines[0] if lines else "unknown card"
