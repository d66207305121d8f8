"""The port's tracing (roman_tpu_torch.tracing) on the CPU.

With no profiler recording, span() is one shared no-op and a grid call or
a register call leaves no record and no count (and never enters
record_function). Under torch.profiler the two calls leave their exact
span trees, one request id a call, the same names among the profiler's
raw events, self times that make up the call, and no wait counted (no
card). A rescued pair nests the rescue pass's spans under engine.rescue.
"""

import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from roman_tpu_torch import tracing
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.align.roman_registration import ROMANParams, ROMANRegistration
from roman_tpu_torch.align.submap_align import PairGridRegistrar
from roman_tpu_torch.parallel import multichip

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMALL_BUDGET = ClipperSolveParams(warmup_iters=2, outer_iters=1, inner_iters=2)


def _grid(seed=11, solver=ClipperSolveParams()):
    """A grid call: 13 pairs of four submaps a side (capacity 16, 16-d) at
    chunk 4, as tests/test_torch_parallel.py's problems."""
    stack = multichip.make_pair_batch(P=4, cap=16, desc_dim=16, seed=seed)
    f1, f2 = (multichip.batch_features(stack, s, CPU) for s in (1, 2))
    ids1 = np.arange(64).reshape(4, 16)
    gi, gj = (g.reshape(-1)[:13] for g in np.meshgrid(np.arange(4), np.arange(4),
                                                      indexing="ij"))
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9, solver=solver)
    reg = PairGridRegistrar(cfg, chunk_size=4, device="cpu")
    return reg, lambda: reg(f1, f2, ids1, ids1 + 1000, gi, gj)


def _objects(stack, side, k):
    return [types.SimpleNamespace(
        center=stack[f"centers{side}"][k, q], volume=float(stack[f"volume{side}"][k, q]),
        linearity=float(stack[f"pca{side}"][k, q, 0]),
        planarity=float(stack[f"pca{side}"][k, q, 1]),
        scattering=float(stack[f"pca{side}"][k, q, 2]),
        semantic_descriptor=stack[f"desc{side}"][k, q])
        for q in np.flatnonzero(stack[f"valid{side}"][k])]


def _register():
    """A register call on one unpadded pair of 12 and 12 objects."""
    stack = multichip.make_pair_batch(P=1, cap=16, desc_dim=16, seed=5)
    reg = ROMANRegistration(ROMANParams(gravity=True, volume=True, pca=True,
                                        semantics_dim=16, cos_min=0.5, cos_max=0.9),
                            device="cpu")
    m1, m2 = _objects(stack, 1, 0), _objects(stack, 2, 0)
    return lambda: reg.register(m1, m2)


def _call(kind):
    return _grid()[1] if kind == "grid" else _register()


CHUNK = ["engine.gather", "registration.solve", "registration.finish"]
TREES = {  # (depth, name) in the order the spans begin
    "grid": ([(0, "engine.call"), (1, "engine.stage"), (1, "engine.stage")]
             + [(1, name) for _ in range(4) for name in CHUNK]
             + [(1, "engine.home"), (1, "engine.rescue"), (1, "engine.home")]),
    "register": [(0, "per_pair.register"), (1, "per_pair.pack"),
                 (1, "registration.solve"), (1, "registration.finish"),
                 (1, "per_pair.home")],
}


def _depths(recs):
    by_id = {r.id: r for r in recs}

    def depth(r):
        return 0 if r.parent is None else 1 + depth(by_id[r.parent])

    return [(depth(r), r.name) for r in recs]


def _profiled(fn, times=1):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(times):
            fn()
    return prof


def test_span_is_one_shared_no_op_without_a_profiler():
    tracing.reset()
    assert tracing.span("engine.call") is tracing.span("per_pair.pack") is tracing.OFF
    with tracing.span("engine.call") as s:
        assert s is None
        tracing.count("sync", 3)
        tracing.count_sync(torch.device("cuda"))
    assert tracing.records() == [] and tracing.counter("sync") == 0


@pytest.mark.parametrize("kind", ["grid", "register"])
def test_calls_leave_nothing_without_a_profiler(kind, monkeypatch):
    fn = _call(kind)
    tracing.reset()

    def refused(name):
        raise AssertionError(f"span {name} entered a record function with no profiler")

    monkeypatch.setattr(tracing, "_RecordFunction", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    fn()
    assert tracing.records() == [] and tracing.counter("sync") == 0


@pytest.mark.parametrize("kind", ["grid", "register"])
def test_calls_leave_their_span_tree_under_the_profiler(kind):
    fn = _call(kind)
    prof = _profiled(fn, times=2)
    recs = tracing.records()
    tree = TREES[kind]
    assert _depths(recs) == tree + tree
    calls = [recs[:len(tree)], recs[len(tree):]]
    for call in calls:
        root = call[0]
        assert root.parent is None and root.request == root.id
        assert {r.request for r in call} == {root.id}
        assert all(r.parent == root.id for r in call[1:])
    assert calls[0][0].request != calls[1][0].request
    names = {n for _, n in tree}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in names]
    for name in names:
        assert sum(e.name() == name for e in events) == sum(r.name == name for r in recs)
    # no user-scope range: it would put an annotation on the device timeline
    assert not any(e.is_user_annotation() for e in events)


@pytest.mark.parametrize("kind", ["grid", "register"])
def test_self_times_make_up_the_call(kind):
    _profiled(_call(kind))
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    for r in recs[1:]:  # each span inside its parent
        p = by_id[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    names = {r.name for r in recs}
    selfs = {n: tracing.self_ns(n) for n in names}
    assert all(v >= 0 for v in selfs.values()), selfs
    root = recs[0]
    total = root.end_ns - root.start_ns
    assert abs(sum(selfs.values()) - total) <= 0.01 * total


@pytest.mark.parametrize("kind", ["grid", "register"])
def test_the_sync_counter_reads_zero_on_the_cpu(kind):
    _profiled(_call(kind))
    assert tracing.records() and tracing.counter("sync") == 0


def test_a_rescued_pair_nests_the_rescue_pass():
    reg, fn = _grid(seed=1, solver=SMALL_BUDGET)
    _profiled(fn)
    assert reg.rescued > 0
    recs = tracing.records()
    rescue = [r for r in recs if r.name == "engine.rescue"]
    assert len(rescue) == 1
    inside = [name for depth, name in _depths(recs)[recs.index(rescue[0]) + 1:]
              if depth == 2]
    chunks = -(-reg.rescued // reg.chunk_size)
    assert inside == ["engine.stage", *CHUNK * chunks, "engine.home"]
    assert all(r.request == recs[0].id for r in recs)


def test_self_time_counters_and_reset_on_known_records(monkeypatch):
    clock = iter([0, 10, 40, 50, 60, 100, 200, 230]).__next__
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=clock))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("root"):           # 0-100
            with tracing.span("a"):          # 10-40
                tracing.count("sync", 2)
            with tracing.span("b"):          # 50-60
                tracing.count_sync(torch.device("cuda"))
                tracing.count_sync(CPU)
        with tracing.span("a"):              # 200-230, a second request
            pass
    assert tracing.self_ns("root") == 60 and tracing.self_ns("a") == 60
    assert tracing.self_ns("b") == 10 and tracing.self_ns("absent") == 0
    assert tracing.counter("sync") == 3 and tracing.counter("absent") == 0
    recs = tracing.records()
    assert [r.request for r in recs] == [recs[0].id] * 3 + [recs[3].id]
    tracing.reset()
    assert tracing.records() == [] and tracing.counter("sync") == 0


def test_device_counts_accumulate_only_while_a_profiler_records():
    """count_device keeps its tensors while a profiler records and sums
    them when the counter is read (after the stretch, so no wait inside
    it); calls with no profiler are ignored, and reset() forgets both
    kinds of count."""
    tracing.reset()
    assert not tracing.recording()
    tracing.count_device("solve.live_rows", torch.tensor([9, 48]))
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        stats = torch.tensor([[9, 1], [48, 1], [1600, 0]], dtype=torch.int32)
        tracing.count("solve.pairs", 3)
        tracing.count_device("solve.live_rows", stats[:, 0])
        tracing.count_device("solve.resident_pairs", stats[:, 1])
        stats[2, 1] = 1  # the sum is taken when the counter is read
    tracing.count_device("solve.live_rows", torch.tensor([5]))
    assert tracing.counter("solve.live_rows") == 1657
    assert tracing.counter("solve.live_rows") == 1657  # read twice, summed once
    assert tracing.counter("solve.resident_pairs") == 3
    assert tracing.counter("solve.pairs") == 3 and tracing.counter("sync") == 0
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count_device("solve.live_rows", torch.tensor([7]))
        tracing.count_device("solve.resident_pairs", torch.tensor([1]))
    assert tracing.counter("solve.live_rows") == 1664
    tracing.reset()
    assert tracing.counter("solve.live_rows") == 0
    assert tracing.counter("solve.resident_pairs") == 0


def test_the_solve_counts_nothing_on_the_cpu():
    """The plain twin that a CPU tensor runs launches nothing, so a traced
    grid call leaves the kernel's solve counters at zero."""
    _profiled(_call("grid"))
    assert tracing.records()
    assert all(tracing.counter(name) == 0
               for name in ("solve.pairs", "solve.live_rows", "solve.resident_pairs"))
