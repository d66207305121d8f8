"""The reader of clipper_solve's compact counter (metrics/compact_share.py)
on a fake context: the compact pairs over the pairs in %, from device
counts made while a profiler recorded; None without a solved pair, without
a trace, without the counter (a program that lacks it) or without the
program's tracing module."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness

tracing = pytest.importorskip("roman_tpu_torch.tracing")

NAME = "compact_share.nosem"


def _ctx():
    return harness.Context(cell=None, trace=types.SimpleNamespace(n_ops=2))


def _solve(stats, compact=True):
    stats = torch.tensor(stats, dtype=torch.int32)
    tracing.count("solve.pairs", len(stats))
    tracing.count_device("solve.resident_pairs", stats[:, 1])
    if compact:
        tracing.count_device("solve.compact_pairs", stats[:, 2])


def test_compact_share_reads_compact_pairs_over_pairs():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _solve([[1600, 0, 1], [1600, 0, 1], [1600, 0, 0]])
        _solve([[9, 1, 0]])
    read = harness.metric_reader(NAME).read
    assert read(_ctx(), NAME) == pytest.approx(50.0)
    assert read(harness.Context(cell=None, trace=None), NAME) is None
    tracing.reset()
    assert read(_ctx(), NAME) is None


def test_a_program_without_the_counter_reads_none():
    """The parent of the compact form counts solved and resident pairs but
    no compact ones: the share is absent, not 0."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _solve([[1600, 0, 0], [1600, 0, 0]], compact=False)
    assert harness.metric_reader(NAME).read(_ctx(), NAME) is None
    tracing.reset()


def test_a_program_without_tracing_reads_none(monkeypatch):
    import roman_tpu_torch

    monkeypatch.delattr(roman_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "roman_tpu_torch.tracing", None)
    assert harness.metric_reader(NAME).read(_ctx(), NAME) is None
