"""The no-GPU cell, align_grid_nosem (roman_no_semantics: no descriptors, a
dense M): its float64 reference on a case with a known answer, the port's
plain path against it, the control failing the cell's limits on the CPU
and, on a card, at the cell's own size, and the faults of
test_bench_faults.py caught in a run of the cell.

The tiny scenes here are conftest.tiny's at scene seed 1. At scene seed 0
(test_bench_harness.py's rehearsal) one pair of the 16 selects otherwise
than the reference, 6.25% against a limit of 2.6%: the reference itself,
with M rounded to bfloat16 as the configuration states, selects what the
program selects there (test_scene_0s_odd_pair_is_bfloat16s_rounding). At
the cell's size such pairs are 0-1.24% of the grid (PERF.md, section 2).
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.entries import pair_grid_nosem
from benchmark.reference import clipper_f64, clipper_f64_nosem, compare
from benchmark.tests.conftest import tiny
from benchmark.tests.test_bench_faults import _drop_strongest, _run, _shift_translation
from benchmark.tests.test_bench_reference import _yaw_T

NAME = "align_grid_nosem"


def _limits():
    return harness.load_json(harness.HERE, "limits", NAME + ".json")


@pytest.fixture
def scene1(bench):
    """conftest's tiny_cell at tiny scene seed 1."""
    def make(name):
        wl, config, traffic = harness.find_cell(bench, name)
        traffic = dict(traffic, trace=dict(traffic["trace"], lead_s=0.1, span_ops=3))
        return wl, tiny(config, 1), traffic

    return make


def test_a_shared_scene_is_registered_exactly():
    """Eight objects seen from two frames related by a yaw and a shift,
    side 2 permuted, no descriptors: every true association is selected
    and Arun's transform is the one that relates the frames."""
    rng = np.random.default_rng(0)
    n = 8
    c1 = rng.uniform(0, 10, size=(n, 3))
    T = _yaw_T(0.7, [3.0, -2.0, 0.5])
    perm = rng.permutation(n)
    c2 = ((c1 - T[:3, 3]) @ T[:3, :3])[perm]       # T @ c2 = c1[perm]
    ratio = rng.uniform(0.2, 1.0, size=(n, 4))
    t = lambda x: torch.as_tensor(x)[None]  # noqa: E731
    v = torch.ones((1, n), dtype=torch.bool)
    res = clipper_f64_nosem.register(t(c1), t(ratio), v, t(c2), t(ratio[perm]), v,
                                     clipper_f64.Params(), rescue=True)
    truth = np.zeros((n, n), bool)
    truth[perm, np.arange(n)] = True
    assert (res["sel"][0].numpy() == truth).all() and int(res["count"][0]) == n
    assert np.abs(res["T"][0].numpy() - T).max() < 1e-9


def test_the_port_agrees_with_the_reference_on_the_cpu(scene1):
    """The port's plain path (bf16 M, f32) on a tiny scene selects what the
    reference selects, within the cell's limits."""
    wl, config, traffic = scene1(NAME)
    cell = harness.entry_module(traffic).Cell(config, traffic, 7, torch.device("cpu"))
    numbers = cell.check([cell.op(0)[0]])
    assert all(ok for *_, ok in compare.judge(numbers, _limits())), numbers


def test_scene_0s_odd_pair_is_bfloat16s_rounding(tiny_cell):
    """At tiny scene seed 0 the program differs from the reference on one
    pair of 16, and selects exactly what the reference selects with M
    rounded to bfloat16, on every pair."""
    wl, config, traffic = tiny_cell(NAME)
    cell = harness.entry_module(traffic).Cell(config, traffic, 7, torch.device("cpu"))
    sel, count, T = cell.op(0)[0]
    assert compare.compare(sel, count, T, cell.reference())["pair_mismatch"] == 1 / 16
    low = pair_grid_nosem.reference(cell.config, cell.subs, cell.pair_i, cell.pair_j,
                                    cell.device, rescue=True, m_dtype=torch.bfloat16)
    assert (np.asarray(sel) == low["sel"]).all()


def test_the_control_fails_on_the_cpu(scene1):
    wl, config, traffic = scene1(NAME)
    for seed in (1, 2, 3):
        cell = harness.entry_module(traffic).Cell(config, traffic, seed, torch.device("cpu"))
        numbers = cell.control()
        assert not all(ok for *_, ok in compare.judge(numbers, _limits())), (seed, numbers)


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(bench, card):
    """The control in the program's place, at the cell's own size, on three
    seeds, each also the scene's: `correct` comes out false on each."""
    wl, config, traffic = harness.find_cell(bench, NAME)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        scene = dict(config, scene=dict(config["scene"], seed=seed))
        cell = harness.entry_module(traffic).Cell(scene, traffic, seed, card)
        cell.release()
        numbers = cell.control()
        assert not all(ok for *_, ok in compare.judge(numbers, _limits())), (seed, numbers)


def test_a_sound_run_is_correct(bench, scene1, capsys):
    assert _run(bench, scene1, capsys, NAME)["correct"] is True


def test_an_altered_selection_is_caught(bench, scene1, capsys, monkeypatch):
    from roman_tpu_torch.align import fused_register

    monkeypatch.setattr(fused_register, "round_refine_plain",
                        _drop_strongest(fused_register.round_refine_plain))
    line = _run(bench, scene1, capsys, NAME)
    assert line["correct"] is False
    assert line["checks"]["pair_mismatch"]["value"] > line["checks"]["pair_mismatch"]["limit"]


def test_an_altered_transform_is_caught(bench, scene1, capsys, monkeypatch):
    from roman_tpu_torch.align import registration

    monkeypatch.setattr(registration, "_t_align_from_selection",
                        _shift_translation(registration._t_align_from_selection))
    line = _run(bench, scene1, capsys, NAME)
    assert line["correct"] is False
    assert line["checks"]["T_gap"]["value"] > line["checks"]["T_gap"]["limit"]
