"""The port's tracing on the card: the wait counter against PyTorch's
sync debug mode, and the spans on the device trace's clock.

Needs a CUDA card and nvcc; without a card every test skips. Imports
nothing of JAX:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        -m cuda tests/test_torch_tracing_cuda.py

After a warm-up, one grid call (with and without a rescue pass) and one
register call each count as many waits (tracing.counter("sync")) as
torch.cuda.set_sync_debug_mode("warn") reports synchronizing operations.
In the profiler's raw events, each registration.solve span encloses the
runtime launches of its four kernels, and the kernels start after it
begins. A 64-pair chunk of each grid cell's scene is solved and finished
under sync debug mode "error" (no wait at all), and on the benchmark's
scene a grid call waits 18 times and a register call 13.
"""

import collections
import types
import warnings

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

pytestmark = pytest.mark.cuda
KERNELS = ("assoc_terms", "build_affinity", "clipper_solve", "round_refine")
SMALL_BUDGET = ClipperSolveParams(warmup_iters=2, outer_iters=1, inner_iters=2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from roman_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


def _grid(dev, solver):
    """36 pairs of six submaps a side at capacity 40, 64-d, chunk 16; the
    small budget leaves pairs for the rescue pass."""
    stack = multichip.make_pair_batch(P=6, cap=40, desc_dim=64, seed=3)
    f1, f2 = (multichip.batch_features(stack, s, dev) for s in (1, 2))
    ids = np.arange(6 * 40).reshape(6, 40)
    gi, gj = (g.reshape(-1) for g in np.meshgrid(np.arange(6), np.arange(6),
                                                 indexing="ij"))
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9, solver=solver)
    reg = PairGridRegistrar(cfg, chunk_size=16, device=dev)
    return reg, lambda: reg(f1, f2, ids, ids + 1000, gi, gj)


def _register(dev):
    """A register call on one unpadded pair of 30 and 30 objects."""
    stack = multichip.make_pair_batch(P=1, cap=40, desc_dim=64, seed=5)

    def objects(side):
        return [types.SimpleNamespace(
            center=stack[f"centers{side}"][0, q], volume=float(stack[f"volume{side}"][0, q]),
            linearity=float(stack[f"pca{side}"][0, q, 0]),
            planarity=float(stack[f"pca{side}"][0, q, 1]),
            scattering=float(stack[f"pca{side}"][0, q, 2]),
            semantic_descriptor=stack[f"desc{side}"][0, q])
            for q in np.flatnonzero(stack[f"valid{side}"][0])]

    reg = ROMANRegistration(ROMANParams(gravity=True, volume=True, pca=True,
                                        semantics_dim=64, cos_min=0.5, cos_max=0.9),
                            device=dev)
    m1, m2 = objects(1), objects(2)
    return lambda: reg.register(m1, m2)


CALLS = {
    "grid": lambda dev: _grid(dev, ClipperSolveParams())[1],
    "grid_rescued": lambda dev: _grid(dev, SMALL_BUDGET)[1],
    "register": _register,
}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_the_sync_counter_equals_sync_debug_modes_count(dev, kind):
    fn = CALLS[kind](dev)
    fn()  # warm-up: kernels loaded, shapes checked
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        # set first: the first setting in a process warns that the mode is
        # a prototype
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert tracing.records()
    assert tracing.counter("sync") == len(syncs) > 0, sorted(collections.Counter(syncs).items())


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_solve_spans_enclose_their_kernels_launches(dev, kind):
    fn = CALLS[kind](dev)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    # the spans put nothing on the device's timeline
    assert not [e.name() for e in events if e.device_type() == DeviceType.CUDA
                and e.name().split(".")[0] in ("engine", "registration", "per_pair")]
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.device_type() == DeviceType.CPU and e.name() == "registration.solve"]
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == DeviceType.CPU and "Launch" in e.name()}
    assert spans and launches
    inside = {s: [] for s in spans}
    for k in events:
        name = next((n for n in KERNELS if n in k.name()), None)
        if k.device_type() != DeviceType.CUDA or name is None:
            continue
        launch = launches.get(k.correlation_id()) or launches.get(k.linked_correlation_id())
        assert launch is not None, k.name()
        s = next((s for s in spans if s[0] <= launch.start_ns() <= launch.end_ns() <= s[1]),
                 None)
        assert s is not None, f"{name}'s launch lies outside every registration.solve span"
        assert k.start_ns() > s[0]
        inside[s].append(name)
    for s, names in inside.items():
        assert sorted(names) == sorted(KERNELS), names


def _scene_cell(dev, workload):
    """The benchmark's cell `workload` on the card, built (and warmed up) as
    benchmark/run.py builds it."""
    import json
    import os

    from benchmark import harness

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, config, traffic = harness.find_cell(bench, workload)
    return harness.entry_module(traffic).Cell(config, traffic, 2**31 + 7, dev)


def _scene_chunk(dev, workload, P=64):
    """(f1, f2, cfg): the first P pairs of the cell's grid, as a chunk of
    the pair engine gathers them."""
    cell = _scene_cell(dev, workload)
    rows = torch.arange(P, device=dev)
    ii = torch.as_tensor(cell.pair_i, device=dev)[rows]
    jj = torch.as_tensor(cell.pair_j, device=dev)[rows]
    f1, f2 = cell.feats[0].map(lambda x: x[ii]), cell.feats[1].map(lambda x: x[jj])
    return f1, f2, cell.registrar.cfg


@pytest.mark.parametrize("workload", ["align_grid", "align_grid_nosem"])
def test_a_chunk_launches_and_finishes_without_a_wait(dev, workload, monkeypatch):
    """After a warm-up, solve_clipper and finish_clipper on a 64-pair chunk
    of the cell's scene (a sparse M, and a dense one) synchronize nothing
    under sync debug mode "error", count no wait, call no library SVD or
    determinant, and count each finished pair's T from the kernel."""
    from roman_tpu_torch.align import registration

    f1, f2, cfg = _scene_chunk(dev, workload)
    registration.finish_clipper(f1, f2, cfg, *registration.solve_clipper(f1, f2, cfg))
    torch.cuda.synchronize()

    def refused(*args, **kwargs):
        raise AssertionError("the finish called a library SVD or determinant")

    for name in ("svd", "det"):
        monkeypatch.setattr(torch.linalg, name, refused)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = registration.finish_clipper(f1, f2, cfg,
                                              *registration.solve_clipper(f1, f2, cfg))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tracing.counter("sync") == 0
    assert tracing.counter("registration.arun_pairs") == 64
    assert res.T_align.shape == (64, 4, 4) and torch.isfinite(res.T_align).all()


@pytest.mark.parametrize("workload,waits", [("align_grid", 18), ("align_register", 13)])
def test_a_scene_call_counts_its_waits(dev, workload, waits):
    """One call of the cell on the configuration's scene after its warm-up:
    a grid call waits 18 times (the ids' and pair indices' uploads and each
    result field's copy home, 10 in its pass and 8 in its rescue pass), a
    register call 13 (twelve uploads and the selection's copy home), and
    every finished pair's T comes from the kernel."""
    cell = _scene_cell(dev, workload)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        cell.op(0)
    torch.cuda.synchronize()
    finished = len(cell.pair_i) + cell.rescued if workload == "align_grid" else 1
    assert tracing.counter("sync") == waits
    assert tracing.counter("registration.arun_pairs") == finished
