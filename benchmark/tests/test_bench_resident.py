"""The reader of clipper_solve's resident counters (metrics/resident_share.py)
on a fake context: the resident pairs over the pairs in %, from device
counts made while a profiler recorded; None without a solved pair, without
a trace or without the program's tracing module."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness

tracing = pytest.importorskip("roman_tpu_torch.tracing")

NAME = "resident_share.grid"


def _ctx():
    return harness.Context(cell=None, trace=types.SimpleNamespace(n_ops=2))


def test_resident_share_reads_resident_pairs_over_pairs():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for stats in ([[9, 1], [48, 1], [1600, 0]], [[3, 1]]):
            stats = torch.tensor(stats, dtype=torch.int32)
            tracing.count("solve.pairs", len(stats))
            tracing.count_device("solve.resident_pairs", stats[:, 1])
    read = harness.metric_reader(NAME).read
    assert read(_ctx(), NAME) == pytest.approx(75.0)
    assert read(harness.Context(cell=None, trace=None), NAME) is None
    tracing.reset()
    assert read(_ctx(), NAME) is None


def test_a_program_without_tracing_reads_none(monkeypatch):
    import roman_tpu_torch

    monkeypatch.delattr(roman_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "roman_tpu_torch.tracing", None)
    assert harness.metric_reader(NAME).read(_ctx(), NAME) is None
