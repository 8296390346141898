"""utils/profiling.py consumers: stage timers + trace context."""

import numpy as np

from dmmt_jpeg_encoder.utils.profiling import StageTimer, stage_timer, trace


def test_stage_timer_laps_and_report():
    t = StageTimer()
    x = np.arange(10).sum()
    dt1 = t.lap("a")
    _ = x + 1
    dt2 = t.lap("b")
    assert dt1 >= 0.0 and dt2 >= 0.0
    report = t.report()
    assert "a:" in report and "b:" in report and "total:" in report


def test_stage_timer_contextmanager():
    with stage_timer() as t:
        np.dot(np.ones((8, 8)), np.ones((8, 8)))
        t.lap("dot")
    assert t.laps and t.laps[0][0] == "dot"


def test_trace_context_no_crash(tmp_path):
    # device trace around a computation: must not raise even if the
    # profiler backend is unavailable in this environment
    with trace(str(tmp_path / "trace")):
        np.dot(np.ones((8, 8)), np.ones((8, 8)))
