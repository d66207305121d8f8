"""The port's adversarial sweep (roman_tpu_torch.eval.adversarial) against
adversarial_eval.py on the CPU, with torch on one thread:

- build_pairs: for each of the eight scenarios, the same problems, pads
  and labels, array for array, at the reference's scene sizes;
- engine_solve: on each scenario's 4 positive and 4 negative pairs at
  capacity 16, 32-d (the scenes scaled to fit by fit_scene), the same
  association counts and LC outcomes (lc_counts) as the reference's
  engine_solve with --cpu semantics (use_pallas=False), T_align within
  1e-4 where a transform is defined. The reference's engine runs once on
  all 64 pairs, its register_clipper under jax.jit (see the fixture);
- the serial referee, the Wilson intervals and P/R: equal to bench.py's
  and adversarial_eval.py's;
- the CLI: the acceptance command writes its table, and without --cpu on
  a host without a card it raises before writing anything.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import adversarial_eval as ref
import bench
from roman_tpu.align import registration as jreg
from roman_tpu.align.clipper import ClipperSolveParams as JaxSolve
from roman_tpu.align.registration import RegistrationConfig as JaxConfig
from roman_tpu_torch.eval import adversarial as adv
from roman_tpu_torch.eval import np_referee

torch.set_num_threads(1)

CAP, DESC, N_POS, N_NEG = 16, 32, 4, 4
NAMES = [name for name, _ in adv.SCENARIOS]


def _pairs(kwargs, capacity=CAP):
    return adv.build_pairs(np.random.default_rng(0), kwargs, N_POS, N_NEG,
                           capacity, DESC)


@pytest.fixture(scope="module")
def jax_engine():
    """The reference's engine_solve on every scenario's pairs at once:
    (counts, T_align, ok), N_POS + N_NEG rows a scenario in SCENARIOS order.
    Its register_clipper runs under jax.jit, one program for each config
    (as PairGridRegistrar runs it): eagerly, each op compiles on its own."""
    pads = [p for _, kw in adv.SCENARIOS for p in _pairs(kw)[1]]
    cfg = JaxConfig(method="roman", cos_min=0.5, cos_max=0.9, use_pallas=False,
                    solver=JaxSolve(n_restarts=1))
    eager = jreg.register_clipper
    programs = {}

    def jitted(f1, f2, cfg, assoc_mask=None):
        assert assoc_mask is None
        key = repr(cfg)
        if key not in programs:
            programs[key] = jax.jit(functools.partial(eager, cfg=cfg))
        return programs[key](f1, f2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreg, "register_clipper", jitted)
        out = ref.engine_solve(pads, cfg)
    assert len(programs) == 2  # the solve and the rescue
    return tuple(np.asarray(x) for x in out)


def test_scenarios_are_the_reference_rows():
    assert [n for n, _ in ref.SCENARIOS] == NAMES
    for (_, a), (_, b) in zip(ref.SCENARIOS, adv.SCENARIOS):
        assert a == b


@pytest.mark.parametrize("k", range(len(NAMES)), ids=NAMES)
def test_pairs_and_engine_outcomes_match_adversarial_eval(k, jax_engine):
    name, kwargs = adv.SCENARIOS[k]
    # the reference's scenes: at capacity 29 every scenario fits unscaled
    for seed in (0, 1000):
        got = adv.build_pairs(np.random.default_rng(seed), kwargs, N_POS, N_NEG, 29, DESC)
        want = ref.build_pairs(np.random.default_rng(seed), kwargs, N_POS, N_NEG, 29, DESC)
        np.testing.assert_array_equal(got[2], want[2])
        for pg, pw in zip(got[0], want[0]):
            for f in dataclasses.fields(pw):
                np.testing.assert_array_equal(getattr(pg, f.name), getattr(pw, f.name))
        for dg, dw in zip(got[1], want[1]):
            assert dg.keys() == dw.keys()
            for key in dw:
                np.testing.assert_array_equal(dg[key], dw[key])

    problems, pads, labels = _pairs(kwargs)
    assert all(len(p.centers1) <= CAP and len(p.centers2) <= CAP for p in problems)
    counts, T, ok = adv.engine_solve(pads, adv.make_config(1), device="cpu")
    rows = slice(k * (N_POS + N_NEG), (k + 1) * (N_POS + N_NEG))
    j_counts, j_T, j_ok = (x[rows] for x in jax_engine)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(ok, j_ok)
    defined = j_counts >= 3
    np.testing.assert_allclose(T[defined], j_T[defined], atol=1e-4)
    assert (adv.lc_counts(counts, T, problems, labels)
            == ref.lc_counts(j_counts, j_T, problems, labels))
    # and the host copy counts as the reference's on the same outputs
    assert (adv.lc_counts(j_counts, j_T, problems, labels)
            == ref.lc_counts(j_counts, j_T, problems, labels))


def test_referee_matches_bench():
    cfg = adv.make_config(1)
    problems = _pairs(dict(adv.SCENARIOS[5][1]), capacity=29)[0][:2]
    problems += _pairs(dict(adv.SCENARIOS[7][1]), capacity=29)[0][-2:]
    counts, Ts = adv.referee_solve(problems, cfg)
    for p, c, T in zip(problems, counts, Ts):
        r1 = np.concatenate([p.pca1, p.volume1[:, None]], axis=1)
        r2 = np.concatenate([p.pca2, p.volume2[:, None]], axis=1)
        args = (p.centers1, r1, p.desc1, p.centers2, r2, p.desc2)
        sel_ref, T_ref = bench._np_solve_pair(*args, cfg)
        sel, T_port = np_referee.np_solve_pair(*args, cfg)
        assert sel == sel_ref and c == len(sel_ref)
        if T_ref is None:
            assert T_port is None
            np.testing.assert_array_equal(T, np.eye(4))
        else:
            np.testing.assert_array_equal(T_port, T_ref)
    assert counts[0] >= 4 and counts[-1] < 4


def test_wilson_and_pr_match_adversarial_eval():
    for n in range(0, 41):
        for k in range(0, n + 1):
            np.testing.assert_allclose(adv.wilson_ci(k, n), ref.wilson_ci(k, n),
                                       rtol=0, atol=1e-12)
    for tp, fp, fn in [(0, 0, 0), (3, 1, 2), (24, 0, 0), (0, 5, 7), (11, 2, 13)]:
        got, want = adv._pr_with_ci(tp, fp, fn), ref._pr_with_ci(tp, fp, fn)
        np.testing.assert_allclose(np.hstack([got[0], got[1], *got[2:]]),
                                   np.hstack([want[0], want[1], *want[2:]]),
                                   rtol=0, atol=1e-12)


def test_fit_scene_keeps_the_reference_scene_where_it_fits():
    for _, kw in adv.SCENARIOS:
        scene = dict(adv.BASE_SCENE, **kw)
        assert adv.fit_scene(scene, 29) == scene
        small = adv.fit_scene(scene, CAP)
        assert adv.scene_side(small) <= CAP and small["n_common"] >= 4


def test_cli_writes_the_table_and_without_a_card_raises_first(tmp_path, monkeypatch, capsys):
    md = tmp_path / "adv.md"
    rows = adv.main(["--cpu", "--pairs", "4", "--capacity", "16", "--desc-dim", "32",
                     "--md", str(md)])
    assert [r["scenario"] for r in rows] == NAMES
    text = md.read_text()
    assert "| Scenario | Engine P | Engine R | Referee P | Referee R |" in text
    for r in rows:
        assert r["pairs"] == 8 and r["positives"] == 4
        assert f"| {r['scenario']} | {r['engine_precision']} [" in text
    assert rows[0]["engine_precision"] == rows[0]["engine_recall"] == 1.0
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        adv.main(["--pairs", "4", "--capacity", "16", "--md", str(tmp_path / "no.md")])
    assert not (tmp_path / "no.md").exists()
    assert capsys.readouterr().out == ""
