"""Profiling helpers (the reference's only profiling is the dct_timing
binary's wall clocks, src/bin/dct_timing.rs:183-237; on the device we add real
tracing).

Usage:
    from dmmt_jpeg_encoder.utils.profiling import trace, stage_timer

    with trace("/tmp/jax-trace"):          # open in XProf/TensorBoard
        encode_array(pixels)

    with stage_timer() as t:
        result = run_device_pipeline(...)
        t.lap("pipeline")
        ...
    print(t.report())
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler device trace around a block (no-op if unavailable)."""
    import jax

    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


class StageTimer:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.laps.append((name, dt))
        return dt

    def report(self) -> str:
        total = sum(dt for _, dt in self.laps)
        lines = [f"{name}: {dt * 1e3:.1f} ms" for name, dt in self.laps]
        lines.append(f"total: {total * 1e3:.1f} ms")
        return " | ".join(lines)


@contextlib.contextmanager
def stage_timer():
    yield StageTimer()
