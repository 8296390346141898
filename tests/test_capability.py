"""Backend selection (utils/capability.py) and the env-keyed program
cache."""

import jax

from dmmt_jpeg_encoder.utils import capability


def test_on_accelerator_false_on_cpu_backend():
    assert jax.default_backend() == "cpu"  # conftest forces this
    assert capability.on_accelerator() is False


def test_auto_scan_backend_is_host_on_cpu():
    assert capability.resolve_scan_backend("auto") == "host"


def test_explicit_scan_backend_passes_through():
    assert capability.resolve_scan_backend("device") == "device"
    assert capability.resolve_scan_backend("host") == "host"


def test_trace_mode_key_reads_env_fresh(monkeypatch):
    monkeypatch.delenv("DMMT_P1", raising=False)
    monkeypatch.delenv("DMMT_TABLE_ABLATE", raising=False)
    assert capability.trace_mode_key() == ("plane", False)
    monkeypatch.setenv("DMMT_P1", "plane2")
    monkeypatch.setenv("DMMT_TABLE_ABLATE", "1")
    assert capability.trace_mode_key() == ("plane2", True)


def test_mode_keyed_cache_rebuilds_on_env_toggle(monkeypatch):
    builds = []

    @capability.mode_keyed_cache(maxsize=4)
    def build(x):
        builds.append(x)
        return object()

    monkeypatch.setenv("DMMT_P1", "plane")
    a = build(1)
    assert build(1) is a and builds == [1]
    monkeypatch.setenv("DMMT_P1", "block")
    assert build(1) is not a and builds == [1, 1]
