"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, with an answer altered where it is produced."""

import json
import time

import pytest
import torch

from benchmark import harness


def _drop_strongest(round_refine_plain):
    """round_refine with the first selected association of every pair
    dropped: each pair's answer altered where it is produced."""
    def broken(M, u, F, omega, n, m, inv):
        sel, count = round_refine_plain(M, u, F, omega, n, m, inv)
        sel = sel.clone()
        first = torch.argmax(sel.to(torch.uint8), dim=-1)
        rows = torch.arange(sel.shape[0])
        sel[rows, first] = False
        return sel, sel.sum(-1).to(count.dtype)
    return broken


def _shift_translation(t_align):
    """Arun's transform with 1 cm added to its x translation."""
    def broken(f1, f2, sel):
        T = t_align(f1, f2, sel).clone()
        T[..., 0, 3] += 0.01
        return T
    return broken


def _run(bench, tiny_cell, capsys, name):
    wl, config, traffic = tiny_cell(name)
    assert harness.run_cell(bench, wl, config, traffic, 9, 0.3, False, time.time(),
                            device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["align_grid", "align_register"])
def test_a_sound_run_is_correct(bench, tiny_cell, capsys, name):
    assert _run(bench, tiny_cell, capsys, name)["correct"] is True


@pytest.mark.parametrize("name", ["align_grid", "align_register"])
def test_an_altered_selection_is_caught(bench, tiny_cell, capsys, monkeypatch, name):
    from roman_tpu_torch.align import fused_register

    monkeypatch.setattr(fused_register, "round_refine_plain",
                        _drop_strongest(fused_register.round_refine_plain))
    line = _run(bench, tiny_cell, capsys, name)
    assert line["correct"] is False
    assert line["checks"]["pair_mismatch"]["value"] > line["checks"]["pair_mismatch"]["limit"]


def test_an_altered_transform_is_caught(bench, tiny_cell, capsys, monkeypatch):
    from roman_tpu_torch.align import registration

    monkeypatch.setattr(registration, "_t_align_from_selection",
                        _shift_translation(registration._t_align_from_selection))
    line = _run(bench, tiny_cell, capsys, "align_grid")
    assert line["correct"] is False
    assert line["checks"]["T_gap"]["value"] > line["checks"]["T_gap"]["limit"]
