"""Adversarial alignment-quality sweep: the port's registration engine
against the serial numpy referee under controlled nuisances (port of
adversarial_eval.py).

For each nuisance level (heavy odometry drift as center noise,
180-degree yaw revisits, duplicated and mirror-symmetric object layouts,
low overlap) it builds positive submap pairs, and matched negatives with
no object in common, with ``sim.world``. It solves every pair with the
batched engine (``registration.register_clipper_rescued``: on the card
the four kernels, on the CPU their plain twins) and with the serial
referee (``eval.np_referee.np_solve_pair``), and reports loop-closure
precision and recall for both with Wilson 95% intervals (reference
evaluator semantics: predicted = >= 4 associations; correct = T within
3 m and 10 degrees of the ground truth, roman/align/evaluate.py:233-288).

    python -m roman_tpu_torch.eval.adversarial [--cpu] [--pairs N] [--seeds K]
        [--capacity C] [--desc-dim D] [--md FILE] [--seed S] [--restarts R]
        [--no-referee]

``--pairs`` is the total positive count of a scenario, split across
``--seeds`` independent seeds (negatives: 2/3 of it, at least 4). The
engine runs on cuda, and a host without a card raises before anything is
written; ``--cpu`` runs it on the CPU. One JSON line a scenario, and with
``--md`` the markdown table.

A scenario's scene has 22 to 29 objects a side. Where ``--capacity`` is
smaller, its object counts are scaled down until they fit (the reference
script asserts there); at 29 and above the pairs are the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from roman_tpu_torch.align import registration
from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.eval.np_referee import np_solve_pair
from roman_tpu_torch.ops import se3_np
from roman_tpu_torch.sim import world

SCENARIOS = [
    # (name, positive-pair kwargs) — negatives reuse the kwargs with the
    # common block removed
    ("baseline", dict(center_noise=0.1)),
    ("drift_0.3m", dict(center_noise=0.3)),
    ("drift_0.6m", dict(center_noise=0.6)),
    ("drift_1.0m", dict(center_noise=1.0)),
    ("yaw_180", dict(center_noise=0.2, yaw=np.pi)),
    ("duplicates_50pct", dict(center_noise=0.2, dup_frac=0.5)),
    ("symmetric_layout", dict(center_noise=0.2, symmetric=True)),
    ("low_overlap", dict(center_noise=0.2, n_common=6,
                         n_only1=17, n_only2=17)),
]
BASE_SCENE = dict(n_common=14, n_only1=8, n_only2=8)


def scene_side(scene: dict) -> int:
    """Objects on the larger side of a positive pair of `scene`."""
    n_dup = int(round(scene.get("dup_frac", 0.0) * scene["n_common"]))
    return scene["n_common"] + max(scene["n_only1"], scene["n_only2"]) + n_dup


def fit_scene(scene: dict, capacity: int) -> dict:
    """`scene` unchanged when a side fits `capacity`; else its three
    object counts scaled by capacity / side (rounded down), then the
    largest lowered one at a time until a side fits."""
    side = scene_side(scene)
    if side <= capacity:
        return scene
    keys = ("n_common", "n_only1", "n_only2")
    out = dict(scene, **{k: int(scene[k] * capacity / side) for k in keys})
    while scene_side(out) > capacity:
        k = max(keys, key=lambda k: out[k])
        out[k] -= 1
    return out


def build_pairs(rng, kwargs, n_pos, n_neg, capacity, desc_dim):
    """n_pos pairs of the scenario and n_neg negatives (no common object),
    drawn in that order from `rng`: the problems, each padded to
    `capacity`, and the labels."""
    base = fit_scene(dict(BASE_SCENE, desc_dim=desc_dim, **kwargs), capacity)
    problems = [world.make_pair_problem(rng, **base) for _ in range(n_pos)]
    neg = dict(base, n_common=0, dup_frac=0.0, symmetric=False)
    neg["n_only1"] = base["n_common"] + base["n_only1"]
    neg["n_only2"] = base["n_common"] + base["n_only2"]
    problems += [world.make_pair_problem(rng, **neg) for _ in range(n_neg)]
    labels = np.array([1] * n_pos + [0] * n_neg, bool)
    pads = [world.pad_problem(p, capacity) for p in problems]
    return problems, pads, labels


def engine_solve(pads, cfg, chunk=64, device=None):
    """The batched engine over every pair, `chunk` pairs at a time, on
    `device` (None: cuda): (counts, T_align, ok) as numpy arrays."""
    device = resolve_device(device)
    counts, Ts, oks = [], [], []
    for lo in range(0, len(pads), chunk):
        part = pads[lo:lo + chunk]

        def stack(key):
            return torch.as_tensor(np.stack([p[key] for p in part]), device=device)

        f1 = registration.build_features(
            stack("centers1"), stack("valid1"), cfg, pca_attrs=stack("pca1"),
            volume=stack("volume1"), extent=stack("extent1"),
            descriptors=stack("desc1"))
        f2 = registration.build_features(
            stack("centers2"), stack("valid2"), cfg, pca_attrs=stack("pca2"),
            volume=stack("volume2"), extent=stack("extent2"),
            descriptors=stack("desc2"))
        res = registration.register_clipper_rescued(f1, f2, cfg)
        counts.append(res.count.cpu().numpy())
        Ts.append(res.T_align.cpu().numpy())
        oks.append(res.ok.cpu().numpy())
    return np.concatenate(counts), np.concatenate(Ts), np.concatenate(oks)


def referee_solve(problems, cfg):
    """The serial referee on every pair, unpadded: (counts, T), with the
    identity where it finds no transform."""
    counts, Ts = [], []
    for p in problems:
        r1 = np.concatenate([p.pca1, p.volume1[:, None]], axis=1)
        r2 = np.concatenate([p.pca2, p.volume2[:, None]], axis=1)
        sel, T = np_solve_pair(p.centers1, r1, p.desc1, p.centers2, r2, p.desc2, cfg)
        counts.append(len(sel))
        Ts.append(T if T is not None else np.eye(4))
    return np.asarray(counts), np.stack(Ts)


def lc_outcomes(counts, Ts, problems, min_assoc=4, dist_thresh=3.0,
                angle_thresh_deg=10.0):
    """Per pair: (predicted, good): a loop closure is predicted at >=
    min_assoc associations, and good when its transform (roll and pitch
    removed) lies within the thresholds of the ground truth."""
    predicted = np.asarray(counts) >= min_assoc
    good = np.zeros(len(problems), bool)
    for k, p in enumerate(problems):
        if predicted[k] and np.isfinite(Ts[k]).all():
            T_hat = se3_np.transform_rm_roll_pitch(Ts[k])
            err = np.linalg.inv(T_hat) @ p.T_gt
            good[k] = (np.linalg.norm(err[:3, 3]) < dist_thresh
                       and np.degrees(se3_np.rotation_magnitude(err[:3, :3]))
                       < angle_thresh_deg)
    return predicted, good


def tally(predicted, good, labels):
    """(tp, fp, fn): a true positive is a predicted, good closure of a
    positive pair; any other prediction is a false positive, any other
    positive pair a false negative."""
    labels = np.asarray(labels, bool)
    tp = predicted & labels & good
    return int(tp.sum()), int((predicted & ~tp).sum()), int((labels & ~tp).sum())


def lc_counts(counts, Ts, problems, labels, min_assoc=4,
              dist_thresh=3.0, angle_thresh_deg=10.0):
    """Raw (tp, fp, fn) so multi-seed runs can pool before dividing."""
    return tally(*lc_outcomes(counts, Ts, problems, min_assoc, dist_thresh,
                              angle_thresh_deg), labels)


def wilson_ci(k, n, z=1.96):
    """Wilson score 95% interval for a binomial proportion k/n."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def _pr_with_ci(tp, fp, fn):
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    p_ci = wilson_ci(tp, tp + fp)
    r_ci = wilson_ci(tp, tp + fn)
    return p, r, p_ci, r_ci


def make_config(restarts: int = 1) -> RegistrationConfig:
    """The sweep's registration: roman, cosine 0.5 to 0.9."""
    return RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9,
                              solver=ClipperSolveParams(n_restarts=restarts))


def seed_split(total: int, n_seeds: int, si: int) -> int:
    """Seed si's share of `total`, split as evenly as possible."""
    return total // n_seeds + (1 if si < total % n_seeds else 0)


def sweep(cfg, device, pairs=24, seeds=1, capacity=40, desc_dim=128, seed=0,
          referee=True):
    """Yields, scenario by scenario, (row, detail): the reference script's
    JSON row, and the per-pair arrays behind it (labels, each solver's
    counts, transforms and (predicted, good) outcomes, its seconds)."""
    n_neg_total = max(pairs * 2 // 3, 4)
    seed_list = [seed + 1000 * s for s in range(max(seeds, 1))]
    for name, kwargs in SCENARIOS:
        acc = {"labels": [], "engine": [], "referee": []}
        secs = {"engine": 0.0, "referee": 0.0}
        for si, s in enumerate(seed_list):
            n_pos = seed_split(pairs, len(seed_list), si)
            n_neg = seed_split(n_neg_total, len(seed_list), si)
            if n_pos == 0 and n_neg == 0:
                continue
            rng = np.random.default_rng(s)
            problems, pads, labels = build_pairs(rng, kwargs, n_pos, n_neg,
                                                 capacity, desc_dim)
            acc["labels"].append(labels)
            t0 = time.perf_counter()
            e_counts, e_T, _ = engine_solve(pads, cfg, device=device)
            secs["engine"] += time.perf_counter() - t0
            acc["engine"].append((e_counts, e_T, *lc_outcomes(e_counts, e_T, problems)))
            if referee:
                t0 = time.perf_counter()
                b_counts, b_T = referee_solve(problems, cfg)
                secs["referee"] += time.perf_counter() - t0
                acc["referee"].append((b_counts, b_T,
                                       *lc_outcomes(b_counts, b_T, problems)))
        labels = np.concatenate(acc["labels"])
        detail = dict(scenario=name, labels=labels, seconds=secs)
        row = dict(scenario=name, pairs=int(len(labels)))
        for who in ("engine", "referee") if referee else ("engine",):
            counts, Ts, predicted, good = (np.concatenate(x) for x in zip(*acc[who]))
            detail[who] = dict(counts=counts, T=Ts, predicted=predicted, good=good)
            p, r, p_ci, r_ci = _pr_with_ci(*tally(predicted, good, labels))
            if who == "engine":
                row.update(positives=int(labels.sum()), seeds=len(seed_list))
            row.update({f"{who}_precision": round(p, 3), f"{who}_recall": round(r, 3),
                        f"{who}_p_ci": [round(x, 3) for x in p_ci],
                        f"{who}_r_ci": [round(x, 3) for x in r_ci]})
        yield row, detail


def scaled_note(capacity: int) -> str:
    """The table's note on scenes scaled down to fit `capacity`."""
    scaled = [name for name, kw in SCENARIOS
              if scene_side(dict(BASE_SCENE, **kw)) > capacity]
    if not scaled:
        return ""
    return (f" At capacity {capacity} the scenes of {', '.join(scaled)} were scaled"
            " down to fit (fit_scene): those rows are not the reference's pairs.")


def markdown(rows, args, n_neg_total, n_seeds) -> str:
    """The table of the reference script's --md, for the port."""
    lines = [
        "# Adversarial alignment-quality sweep",
        "",
        "Engine (roman_tpu_torch: the four CUDA kernels on the card, their"
        " plain twins with --cpu) vs the full-budget serial numpy referee on"
        " synthetic submap pairs per nuisance level, with matched no-overlap"
        f" negatives ({args.pairs} positives + {n_neg_total} negatives per"
        f" scenario pooled over {n_seeds} independent seeds,"
        f" capacity {args.capacity}, {args.desc_dim}-d descriptors;"
        " LC = >=4 associations, correct = <3 m / <10 deg vs GT)."
        " Brackets are Wilson 95% binomial CIs on the pooled counts."
        + scaled_note(args.capacity),
        "",
        f"Generated by `python -m roman_tpu_torch.eval.adversarial --pairs {args.pairs}"
        f" --seeds {args.seeds}"
        + (" --cpu" if args.cpu else "")
        + (f" --capacity {args.capacity}" if args.capacity != 40 else "")
        + (f" --desc-dim {args.desc_dim}" if args.desc_dim != 128 else "")
        + (f" --restarts {args.restarts}" if args.restarts > 1 else "")
        + f" --seed {args.seed}`.",
        "",
        "| Scenario | Engine P | Engine R | Referee P | Referee R |",
        "|---|---|---|---|---|",
    ]

    def _fmt(v, ci):
        return f"{v} [{ci[0]:.3f}, {ci[1]:.3f}]"

    for r in rows:
        # an engine-only run (--no-referee) shows no referee number: a 0.0
        # there would read as a failed referee, not as "not measured"
        ref_p = (_fmt(r["referee_precision"], r["referee_p_ci"])
                 if "referee_precision" in r else "— (not run)")
        ref_r = (_fmt(r["referee_recall"], r["referee_r_ci"])
                 if "referee_recall" in r else "— (not run)")
        lines.append(
            f"| {r['scenario']} |"
            f" {_fmt(r['engine_precision'], r['engine_p_ci'])} |"
            f" {_fmt(r['engine_recall'], r['engine_r_ci'])} |"
            f" {ref_p} | {ref_r} |")
    return "\n".join(lines) + "\n"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m roman_tpu_torch.eval.adversarial")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: cuda)")
    ap.add_argument("--pairs", type=int, default=24,
                    help="TOTAL positive pairs per scenario, split across"
                         " --seeds (negatives = 2/3)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent seeds the pair budget is split over")
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--desc-dim", type=int, default=128)
    ap.add_argument("--md", type=str, default=None,
                    help="write the markdown table here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--restarts", type=int, default=1,
                    help="engine ClipperSolveParams.n_restarts (the "
                         "referee stays single-start by design)")
    ap.add_argument("--no-referee", action="store_true",
                    help="skip the serial referee (engine-only rows)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Runs the sweep; returns the rows it printed."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = make_config(args.restarts)
    rows = []
    for row, _ in sweep(cfg, device, pairs=args.pairs, seeds=args.seeds,
                        capacity=args.capacity, desc_dim=args.desc_dim,
                        seed=args.seed, referee=not args.no_referee):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.md:
        os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
        with open(args.md, "w") as f:
            f.write(markdown(rows, args, max(args.pairs * 2 // 3, 4),
                             max(args.seeds, 1)))
        print(f"# wrote {args.md}", flush=True)
    return rows


if __name__ == "__main__":
    main()
