"""The readers of the program's spans and wait counter (metrics/span_ms.py,
metrics/syncs_per_call.py) on a fake context, with the program's tracing
fed known records: the span named inside the metric's name, its self time
a call, None for an absent span, an empty record or a program without the
tracing module."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness

tracing = pytest.importorskip("roman_tpu_torch.tracing")


def _ctx(n_ops):
    return harness.Context(cell=None, trace=types.SimpleNamespace(n_ops=n_ops))


@pytest.fixture
def fed(monkeypatch):
    """Two register calls' spans on a fake clock (ns), 7 waits counted."""
    clock = iter([0, 1_000_000, 4_000_000, 5_000_000, 6_000_000, 10_000_000,
                  20_000_000, 21_000_000, 23_000_000, 30_000_000]).__next__
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=clock))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("per_pair.register"):                # 0-10 ms
            with tracing.span("registration.finish"):          # 1-4
                tracing.count_sync(torch.device("cuda"), 5)
            with tracing.span("per_pair.home"):                # 5-6
                pass
        with tracing.span("per_pair.register"):                # 20-30
            with tracing.span("registration.finish"):          # 21-23
                tracing.count("sync", 2)
    yield
    tracing.reset()


def test_span_ms_reads_the_named_spans_self_time_a_call(fed):
    read = harness.metric_reader("span_ms.registration.finish.register").read
    assert read(_ctx(2), "span_ms.registration.finish.register") == pytest.approx(2.5)
    assert read(_ctx(2), "span_ms.per_pair.home.register") == pytest.approx(0.5)
    # the root's self time: 10 - 3 - 1 and 10 - 2 ms
    assert read(_ctx(4), "span_ms.per_pair.register.grid") == pytest.approx(3.5)
    assert read(_ctx(2), "span_ms.engine.stage.grid") is None
    assert read(harness.Context(cell=None, trace=None),
                "span_ms.per_pair.home.register") is None


def test_syncs_per_call_divides_the_counter_by_the_calls(fed):
    read = harness.metric_reader("syncs_per_call.register").read
    assert read(_ctx(2), "syncs_per_call.register") == pytest.approx(3.5)
    assert read(_ctx(7), "syncs_per_call.grid") == pytest.approx(1.0)


def test_no_records_read_none():
    tracing.reset()
    for name in ("span_ms.per_pair.pack.register", "syncs_per_call.register"):
        assert harness.metric_reader(name).read(_ctx(3), name) is None


def test_a_program_without_tracing_reads_none(monkeypatch):
    import roman_tpu_torch

    monkeypatch.delattr(roman_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "roman_tpu_torch.tracing", None)
    for name in ("span_ms.engine.stage.grid", "syncs_per_call.grid"):
        assert harness.metric_reader(name).read(_ctx(3), name) is None
