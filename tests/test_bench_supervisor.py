"""Supervisor-layer tests for bench.py: harvest metric lines, survive
hangs, keep partial metrics, end with the device-program metric line, and
exit nonzero whenever the measuring child fails.

These run stub children (no jax, no GPU) to exercise the harvesting,
timeout-kill, and canonical-ordering logic.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import bench


def _stub(tmp_path: Path, body: str) -> list:
    p = tmp_path / "stub_child.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


def test_harvests_json_lines_and_streams(tmp_path, capsys):
    cmd = _stub(
        tmp_path,
        """
        import json
        print("devices: stub")  # non-JSON noise must go to stderr
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 1.0, "unit": "Mpix/s"}))
        print(json.dumps({"metric": "4k_device_program_throughput",
                          "value": 2.0, "unit": "Mpix/s"}))
        """,
    )
    metrics = {}
    rc = bench._run_attempt(cmd, timeout_s=60, metrics=metrics)
    assert rc == 0
    assert set(metrics) == {
        "4k_rgb_to_jpeg_throughput",
        "4k_device_program_throughput",
    }
    out = capsys.readouterr()
    # JSON lines streamed to stdout; noise diverted to stderr.
    assert "devices: stub" not in out.out
    assert '"4k_device_program_throughput"' in out.out


def test_partial_metrics_survive_child_crash(tmp_path):
    cmd = _stub(
        tmp_path,
        """
        import json, sys
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 3.0, "unit": "Mpix/s"}),
              flush=True)
        sys.exit(7)  # crash after the first stage
        """,
    )
    metrics = {}
    rc = bench._run_attempt(cmd, timeout_s=60, metrics=metrics)
    assert rc == 7
    assert metrics["4k_rgb_to_jpeg_throughput"]["value"] == 3.0


def test_timeout_kills_hung_child(tmp_path):
    cmd = _stub(
        tmp_path,
        """
        import json, time
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 4.0, "unit": "Mpix/s"}),
              flush=True)
        time.sleep(3600)  # a hung child: block forever
        """,
    )
    metrics = {}
    rc = bench._run_attempt(cmd, timeout_s=3, metrics=metrics)
    assert rc is None  # timed out, child killed by exact PID
    assert metrics["4k_rgb_to_jpeg_throughput"]["value"] == 4.0


def test_metric_order_puts_program_floor_last():
    assert bench.METRIC_ORDER[-1] == "4k_device_program_throughput"


def _patch_child(monkeypatch, stub):
    real_run = bench._run_attempt
    monkeypatch.setattr(
        bench,
        "_run_attempt",
        lambda cmd, t, m: real_run([sys.executable, str(stub)], t, m),
    )
    monkeypatch.setattr(sys, "argv", ["bench.py", "--timeout", "60"])


def _captured_json(monkeypatch):
    out = []
    monkeypatch.setattr(
        "builtins.print",
        lambda *a, **kw: out.append(a) if kw.get("file") is None else None,
    )
    return out


def test_end_to_end_supervisor_orders(tmp_path, monkeypatch):
    """A child emitting metrics out of order: the final stdout line must
    be the device-program metric, marked final."""
    stub = tmp_path / "child.py"
    stub.write_text(
        textwrap.dedent(
            """
            import json
            for metric, v in [("4k_device_program_throughput", 20.0),
                              ("4k_rgb_to_jpeg_throughput", 10.0)]:
                print(json.dumps({"metric": metric, "value": v,
                                  "unit": "Mpix/s"}), flush=True)
            """
        )
    )
    _patch_child(monkeypatch, stub)
    out = _captured_json(monkeypatch)
    assert bench.main() == 0
    last = json.loads(out[-1][0])
    assert last["metric"] == "4k_device_program_throughput"
    assert last["value"] == 20.0 and last["final"] is True


def test_failing_child_after_metrics_returns_nonzero(tmp_path, monkeypatch):
    """A stage failure after some metrics were measured fails the run;
    the measured metrics are still re-emitted."""
    stub = tmp_path / "child.py"
    stub.write_text(
        textwrap.dedent(
            """
            import json, sys
            print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                              "value": 1.0, "unit": "Mpix/s"}), flush=True)
            sys.exit(3)
            """
        )
    )
    _patch_child(monkeypatch, stub)
    out = _captured_json(monkeypatch)
    assert bench.main() == 1
    assert json.loads(out[-1][0])["metric"] == "4k_rgb_to_jpeg_throughput"


def test_all_attempts_failing_returns_rc1(tmp_path, monkeypatch):
    stub = tmp_path / "dead_child.py"
    stub.write_text("import sys; sys.exit(1)\n")
    _patch_child(monkeypatch, stub)
    assert bench.main() == 1
