"""The port's `roman_no_semantics` path (the upstream no-GPU deployment:
gravity, volume and PCA shape ratios, no descriptors) against the
benchmark's float64 reference for it, `benchmark/reference/clipper_f64_nosem.py`,
on the CPU at a small size; and the counters that the benchmark's no-GPU
cell reads (`affinity.nonzeros`, `affinity.pairs`, `engine.rescued_pairs`).

Scenes are the benchmark's world (`benchmark/world.py`) cut to capacity 12:
150 objects, two 40 m drives, descriptors drawn (so the objects are the
world's) and then dropped, as the cell's entry drops them.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import world
from benchmark.entries import align_common, pair_grid_nosem
from benchmark.reference import clipper_f64, clipper_f64_nosem
from roman_tpu_torch import tracing
from roman_tpu_torch.align import fused_register as fr
from roman_tpu_torch.align import invariants
from roman_tpu_torch.align import registration as reg
from roman_tpu_torch.align.submap_align import PairGridRegistrar

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", "roman-demo-nogpu-align.json")) as f:
        return json.load(f)


def _scene(scene_seed):
    """(config, both robots' submaps with no descriptors, pair_i, pair_j)."""
    config = copy.deepcopy(_config())
    config["scene"].update(seed=scene_seed, n_objects=150, area_m=[40.0, 40.0, 3.0],
                           traj_len_m=40.0, desc_dim=32, n_classes=16)
    config["align"]["submap_max_size"] = 12
    subs = [dataclasses.replace(s, desc=s.desc[..., :0]) for s in world.make_scene(config)]
    pi, pj = world.full_grid(subs)
    return config, subs, pi, pj


def _pairs(subs, pi, pj, dtype=torch.float32):
    """Both sides' SubmapFeatures gathered pair by pair."""
    feats = [align_common.features(s, CPU) for s in subs]
    return [f.map(lambda x, k=k: x[torch.as_tensor(k)].to(dtype) if x.is_floating_point()
                  else x[torch.as_tensor(k)]) for f, k in zip(feats, (pi, pj))]


def test_the_reference_affinity_is_the_ports_plain_affinity():
    """The reference's M is the port's plain invariants.affinity for
    pcavolgrav with no descriptors, both in float64, within 1e-9, and so
    are its nonzero counts; the three-term fusion of clipper_f64 (a cube
    root where two terms are enabled) is not."""
    config, subs, pi, pj = _scene(0)
    f1, f2 = _pairs(subs, pi[:8], pj[:8], torch.float64)
    cfg = align_common.registration_config(config)
    assert cfg.method == "pcavolgrav" and cfg.solve_flags == (True, True, False)
    M4, _ = invariants.affinity(f1, f2, cfg.invariant_params(4), dtype=torch.float64)
    B, n, m = M4.shape[0], f1.capacity, f2.capacity
    M_port = M4.reshape(B, n * m, n * m)
    p = clipper_f64.Params.from_config(config)
    sides = [(f.centers, f.ratio_feats, f.valid) for f in (f1, f2)]
    M_ref, live = clipper_f64_nosem.affinity(*sides[0], *sides[1], p)
    assert M_ref.dtype == torch.float64
    assert (M_ref - M_port).abs().max().item() <= 1e-9
    assert torch.equal(live, fr.offdiag_nonzeros(M_port))
    assert (live > 0.5 * f1.valid.sum(-1) * f2.valid.sum(-1)).any()  # a dense M
    empty = f1.descriptors
    M_three, _ = clipper_f64.affinity(f1.centers, f1.ratio_feats, empty, f1.valid,
                                      f2.centers, f2.ratio_feats, f2.descriptors, f2.valid, p)
    assert (M_three - M_port).abs().max().item() > 1e-3


def _clear(config, subs, pi, pj, rescue):
    """The reference's answers, and the pairs whose selection the
    configuration's own rounding leaves alone: the reference with M
    rounded to bfloat16 selects the same there, so the margin between
    the best candidates is above bfloat16's rounding."""
    ref = pair_grid_nosem.reference(config, subs, pi, pj, CPU, rescue=rescue)
    low = pair_grid_nosem.reference(config, subs, pi, pj, CPU, rescue=rescue,
                                    m_dtype=torch.bfloat16)
    clear = (ref["sel"] == low["sel"]).reshape(len(pi), -1).all(-1)
    return ref, clear


def _spans_a_plane(subs, pi, pj, sel):
    """(P,) bool: the selected centers' cross-covariance has a second
    singular value above 1% of its first. On a near-collinear selection
    float32 alone moves Arun's T by more than 1e-4 (the reference's own
    Arun in float32 moved one such pair of scene 0 by 2.2e-4)."""
    out = np.zeros(len(pi), bool)
    for k, (i, j) in enumerate(zip(pi, pj)):
        a, b = np.nonzero(sel[k])
        if len(a) >= 3:
            x1 = subs[0].centers[i][a].astype(np.float64)
            x2 = subs[1].centers[j][b].astype(np.float64)
            sv = np.linalg.svd((x1 - x1.mean(0)).T @ (x2 - x2.mean(0)), compute_uv=False)
            out[k] = sv[1] > 1e-2 * sv[0]
    return out


@pytest.mark.parametrize("path", ["register_clipper", "grid"])
def test_the_ports_cpu_path_matches_the_reference(path):
    """register_clipper (one pass) and PairGridRegistrar (with its rescue
    pass) with method roman_no_semantics on two seeded scenes at capacity
    12: equal selections wherever the reference's margin is clear (most
    pairs), and T_align within 1e-4 where the selections agree on three or
    more associations that span more than a line."""
    n_clear = n_pairs = n_T = 0
    for scene_seed in (0, 1):
        config, subs, pi, pj = _scene(scene_seed)
        cfg = align_common.registration_config(config)
        rescue = path == "grid"
        if rescue:
            feats = [align_common.features(s, CPU) for s in subs]
            res = PairGridRegistrar(cfg, chunk_size=8, device="cpu")(
                feats[0], feats[1], subs[0].ids, subs[1].ids, pi, pj)
            sel, T = res.sel, res.T_align
        else:
            out = reg.register_clipper(*_pairs(subs, pi, pj), cfg)
            sel, T = out.sel.numpy(), out.T_align.numpy()
        ref, clear = _clear(config, subs, pi, pj, rescue)
        same = (sel == ref["sel"]).reshape(len(pi), -1).all(-1)
        assert same[clear].all(), np.flatnonzero(clear & ~same)
        agree = same & (ref["count"] >= 3) & _spans_a_plane(subs, pi, pj, ref["sel"])
        if agree.any():
            assert np.abs(T[agree] - ref["T"][agree]).max() <= 1e-4
        n_clear, n_pairs, n_T = n_clear + clear.sum(), n_pairs + len(pi), n_T + agree.sum()
    assert n_clear >= 0.75 * n_pairs and n_T > 0


def test_the_counters_equal_the_twins_own_counts():
    """A traced grid call counts, in affinity.nonzeros, the nonzeros off
    the diagonal of each M the twins build (every pair once, each rescued
    pair again), in affinity.pairs the pairs built, and in
    engine.rescued_pairs the pairs whose first solve did not converge;
    within 2% of the reference's own count. Untraced, nothing is counted."""
    config, subs, pi, pj = _scene(0)
    cfg = align_common.registration_config(config)
    feats = [align_common.features(s, CPU) for s in subs]
    registrar = PairGridRegistrar(cfg, chunk_size=8, device="cpu")

    def call():
        return registrar(feats[0], feats[1], subs[0].ids, subs[1].ids, pi, pj)

    tracing.reset()
    call()
    assert not tracing.counted("engine.rescued_pairs")
    assert tracing.counter("affinity.pairs") == tracing.counter("affinity.nonzeros") == 0
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    counts = {k: tracing.counter(k) for k in ("affinity.nonzeros", "affinity.pairs",
                                                 "engine.rescued_pairs")}
    tracing.reset()

    f1, f2 = _pairs(subs, pi, pj)
    inv = reg.fused_statics(cfg, f1)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float()
    hl, nz, single, vflat = fr.assoc_terms_plain(f1.ratio_feats, f1.descriptors,
                                                 f2.ratio_feats, f2.descriptors, valid, inv)
    M = fr.build_affinity_plain(f1.centers, f2.centers, hl, nz, single, vflat, inv)
    per_pair = fr.offdiag_nonzeros(M)
    bad = ~reg.register_clipper(f1, f2, cfg).converged
    assert 0 < int(bad.sum()) == registrar.rescued
    assert counts == {"affinity.nonzeros": int(per_pair.sum() + per_pair[bad].sum()),
                      "affinity.pairs": len(pi) + registrar.rescued,
                      "engine.rescued_pairs": registrar.rescued}
    ref = pair_grid_nosem.reference(config, subs, pi, pj, CPU, rescue=True)
    assert abs(per_pair.double().mean().item() / ref["live"].mean() - 1) < 0.02


def test_counted_tells_a_counter_of_zero_from_an_absent_one():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("engine.rescued_pairs", 0)
        tracing.count_device("affinity.nonzeros", torch.tensor([0]))
    assert tracing.counted("engine.rescued_pairs") and tracing.counted("affinity.nonzeros")
    assert not tracing.counted("absent")
    assert tracing.counter("engine.rescued_pairs") == 0
    tracing.reset()
    assert not tracing.counted("engine.rescued_pairs")
