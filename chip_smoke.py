#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It drives only ``roman_tpu_torch`` (no JAX, nothing of ``roman_tpu``). It
builds the port's kernels from ``roman_tpu_torch/csrc`` with nvcc for
sm_90a, makes the world of bench.py's workload with the port's own
``sim.world`` (seed 0, 1000 objects, two 240 m trajectories, 768-d
descriptors, submap capacity 40: a 23 x 22 grid of 506 submap pairs with
N = 1600 candidate associations each), and then:

1. prints the card, its power limit and the build (registers, shared
   memory and spills of every kernel);
2. holds each of the four kernels against its plain PyTorch twin on the
   card, on 32 pairs (the chunk the main path registers at once), and
   times both with CUDA events; holds and times the CLIPPER solve also on
   1 and 8 pairs and at the rescue budget (pairs, blocks per pair, GB/s
   of M streamed), beside a yardstick: one torch.bmm of bf16 u by M,
   times the solve's matvec count;
3. runs the alignment stage through its entry point ``submap_align`` from
   map pickles, with every launch count set to 0 just before and read just
   after, and checks the artifacts it writes;
4. registers the full pair grid with ``PairGridRegistrar``: pairs/s (best
   of 3 after a warmup with the full pair list), launch counts, a
   profile of device time by kernel with the rescue launch's pairs and
   device time, agreement with the plain path on the
   card over the first 100 pairs, and loop-closure precision/recall
   against the sim ground truth;
5. registers 16 pairs with arithmetic-mean fusion, which reaches the
   CLIPPER solve kernel directly, against the plain path;
6. prints one JSON line of per-kernel numbers, the card's name and power
   limit again, and last {"ok": true, "device": {...}}.

Every check raises on failure, so the script then exits non-zero and
prints no result line. Without a CUDA card it exits with code 1 at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
BF16_FLOPS = 989e12     # bf16 tensor cores

SEED = 0
CAPACITY = 40
DESC_DIM = 768
KERNEL_PAIRS = 32       # phase 2 batch, and the main path's chunk size
QUALITY_PAIRS = 100
ARITH_PAIRS = 16


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output."""
    lines, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # Itanium-mangled: <length><name>, then I(L<type><value>E)+E for
            # the integer and bool template arguments
            k = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
            args = [{"b0": "false", "b1": "true"}.get(t + v, v)
                    for t, v in re.findall(r"L([ib])(\d+)E", k.group(2) or "")] if k else []
            name = (k.group(1) + (f"<{', '.join(args)}>" if args else "")
                    if k else m.group(1))
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", ln)
        if m and name:
            smem = f", static smem {m.group(2)} B" if m.group(2) else ""
            lines.append(f"{name}: {m.group(1)} registers{smem}, {spill}")
            name = None
    return lines


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms: one warmup call, then reps calls
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """Least time in ms for moving n_bytes through HBM and doing the
    operations at the card's peak for their type; and which one binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# the bench world
# ---------------------------------------------------------------------------

def make_world(seed=SEED, n_objects=1000, traj_len=240.0, desc_dim=DESC_DIM):
    """bench.py build_workload's world (bench.py:31-60), from the port's
    sim.world: two robots' runs and their map artifacts."""
    from roman_tpu_torch.sim import world

    rng = np.random.default_rng(seed)
    _, runs = world.make_multi_robot_world(
        rng, n_robots=2, n_objects=n_objects, area=(100.0, 100.0, 4.0),
        traj_len=traj_len, desc_dim=desc_dim, odom_drift_per_m=0.002,
        n_classes=256, instance_noise=0.45)
    return runs, [world.roman_map_from_run(r) for r in runs]


def grid_features(maps, device, capacity=CAPACITY, desc_dim=DESC_DIM):
    """Submaps of both maps and their padded features on `device`, as
    bench.py builds them (radius 15 m, a submap every 10 m)."""
    from roman_tpu_torch.align.registration import RegistrationConfig
    from roman_tpu_torch.map.roman_map import (SubmapParams,
                                               submaps_from_roman_map,
                                               submaps_to_features)

    params = SubmapParams(max_size=capacity, radius=15.0, distance=10.0)
    submaps = [submaps_from_roman_map(m, params) for m in maps]
    cfg = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9)
    feats, auxs = zip(*[submaps_to_features(sm, cfg, capacity=capacity,
                                            desc_dim=desc_dim, device=device)
                        for sm in submaps])
    return submaps, list(feats), list(auxs), cfg


def full_grid(feats):
    n0, n1 = feats[0].centers.shape[0], feats[1].centers.shape[0]
    pi, pj = np.meshgrid(np.arange(n0), np.arange(n1), indexing="ij")
    return pi.reshape(-1), pj.reshape(-1)


def gt_relative_poses(auxs, runs, pair_i, pair_j):
    """(P, 4, 4) yaw-only ground-truth relative submap poses (bench.py:63-77)."""
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.ops import se3_np

    gt = [PoseData.from_times_and_poses(r.times, r.poses, time_tol=10.0)
          for r in runs]
    T_gt = [se3_np.transform_rm_roll_pitch(
        np.stack([gt[k].pose(float(t)) for t in aux["times"]]))
        for k, aux in enumerate(auxs)]
    return np.stack([np.linalg.inv(T_gt[0][i]) @ T_gt[1][j]
                     for i, j in zip(pair_i, pair_j)])


def lc_quality_from_lists(ok, count, T_align, T_ij_all, min_assoc=4,
                          dist_thresh=5.0, angle_thresh_deg=10.0, radius=15.0):
    """Loop-closure precision and recall against sim ground truth, the rule
    of bench.py:80-110: positive = GT submap distance < 2 * radius; a
    predicted closure is right when its error after yaw-only projection is
    within the thresholds; a wrong one on a positive pair is both a false
    positive and a miss."""
    from roman_tpu_torch.ops import se3_np

    tp = fp = fn = 0
    for idx in range(len(ok)):
        T_ij = T_ij_all[idx]
        positive = np.linalg.norm(T_ij[:3, 3]) < 2 * radius
        predicted = bool(ok[idx]) and int(count[idx]) >= min_assoc
        good = False
        if predicted:
            err = np.linalg.inv(se3_np.transform_rm_roll_pitch(T_align[idx])) @ T_ij
            good = (np.linalg.norm(err[:3, 3]) < dist_thresh
                    and np.degrees(se3_np.rotation_magnitude(err[:3, :3]))
                    < angle_thresh_deg)
        if predicted and positive and good:
            tp += 1
        else:
            fp += int(predicted)
            fn += int(positive)
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


@contextlib.contextmanager
def plain_path():
    """Route registration through the plain twins, on whatever device the
    tensors are: the reference the kernels are held against on the card.
    Swaps the two names the registration path looks up for its kernels."""
    from roman_tpu_torch.align import clipper_solve, fused_register, registration

    saved = registration.fused_register, clipper_solve.clipper_solve
    registration.fused_register = fused_register.fused_register_plain
    clipper_solve.clipper_solve = clipper_solve.clipper_solve_plain
    try:
        yield
    finally:
        registration.fused_register, clipper_solve.clipper_solve = saved


def reset_launches():
    from roman_tpu_torch.align.fused_register import KERNELS

    for k in KERNELS:
        k.launches = 0


def read_launches() -> dict:
    from roman_tpu_torch.align.fused_register import KERNELS

    return {k.__name__: k.launches for k in KERNELS}


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin
# ---------------------------------------------------------------------------

def kernel_pairs(auxs, n_pairs=KERNEL_PAIRS):
    """Half the pairs nearest in odometry (so rounding selects real
    matches), half spread evenly over the grid."""
    d = np.linalg.norm(auxs[0]["positions"][:, None] - auxs[1]["positions"][None],
                       axis=-1).reshape(-1)
    near = np.argsort(d, kind="stable")[:n_pairs // 2]
    rest = np.setdiff1d(np.arange(d.size), near)
    spread = rest[np.linspace(0, rest.size - 1, n_pairs - near.size).astype(int)]
    flat = np.sort(np.concatenate([near, spread]))
    n1 = auxs[1]["positions"].shape[0]
    return flat // n1, flat % n1


def check_kernels(feats, auxs, cfg, reps=10, plain_reps=3):
    """Each kernel and its twin on the same inputs, on the card. Returns
    one record per kernel (without launches)."""
    import torch

    from roman_tpu_torch.align import clipper
    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper_solve import (clipper_solve,
                                                     clipper_solve_plain,
                                                     cluster_size)
    from roman_tpu_torch.align.registration import rescue_solver

    pi, pj = kernel_pairs(auxs)
    dev = feats[0].centers.device
    ii = torch.as_tensor(pi, device=dev)
    jj = torch.as_tensor(pj, device=dev)
    f1 = feats[0].map(lambda x: x[ii].contiguous())
    f2 = feats[1].map(lambda x: x[jj].contiguous())
    P, n, m = len(pi), f1.capacity, f2.capacity
    N = n * m
    inv = fr.FusedInvariantStatics(cos_min=cfg.cos_min, cos_max=cfg.cos_max,
                                   max_clique=cfg.max_clique)
    params = cfg.solver
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    F = f1.ratio_feats.shape[-1]
    D = f1.descriptors.shape[-1]
    records = []

    # ---- assoc_terms ----
    a_args = (f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors,
              valid, inv)
    k_out, p_out = fr.assoc_terms(*a_args), fr.assoc_terms_plain(*a_args)
    torch.cuda.synchronize()
    hl_k, nz_k, single_k, vflat_k = k_out
    hl_p, nz_p, single_p, vflat_p = p_out
    score_k, score_p = torch.exp(2 * hl_k) * nz_k, torch.exp(2 * hl_p) * nz_p
    err = max((score_k - score_p).abs().max().item(),
              (single_k - single_p).abs().max().item())
    print(f"assoc_terms: max |d score|, |d single| {err:.3e} (tol 1e-5); "
          f"nz equal {torch.equal(nz_k, nz_p)}, valid equal "
          f"{torch.equal(vflat_k, vflat_p)}", flush=True)
    require(err <= 1e-5 and torch.equal(nz_k, nz_p)
            and torch.equal(vflat_k, vflat_p), "assoc_terms disagrees with its twin")
    n_bytes = nbytes(*a_args[:5], *k_out)
    ops = P * (2.0 * N * D + 2.0 * (n + m) * D + 10.0 * N * F + 20.0 * N)
    records.append(dict(
        name="assoc_terms", max_abs_err=err,
        ms=cuda_ms(lambda: fr.assoc_terms(*a_args), reps),
        plain_ms=cuda_ms(lambda: fr.assoc_terms_plain(*a_args), plain_reps),
        bound=bound(n_bytes, f32_ops=ops)))

    # ---- build_affinity (both fed the plain twin's terms) ----
    b_args = (f1.centers, f2.centers, hl_p, nz_p, single_p, vflat_p, inv)
    M_k, M_p = fr.build_affinity(*b_args), fr.build_affinity_plain(*b_args)
    torch.cuda.synchronize()
    ulp = (M_k.view(torch.int16).int() - M_p.view(torch.int16).int()).abs()
    err = (M_k.float() - M_p.float()).abs().max().item()
    print(f"build_affinity: max bf16 ulps {ulp.max().item()} (tol 1), entries "
          f"off by one ulp {int((ulp == 1).sum())} of {M_k.numel()}, "
          f"max |dM| {err:.3e}", flush=True)
    require(ulp.max().item() <= 1, "build_affinity disagrees with its twin")
    # about 50 f32 operations per entry, 8 of them sqrt/exp/log
    records.append(dict(
        name="build_affinity", max_abs_err=err,
        ms=cuda_ms(lambda: fr.build_affinity(*b_args), reps),
        plain_ms=cuda_ms(lambda: fr.build_affinity_plain(*b_args), plain_reps),
        bound=bound(nbytes(*b_args[:6], M_k), f32_ops=50.0 * P * N * N)))
    del M_k

    # ---- clipper_solve (both on the twin's affinity), on the main path's
    # chunk, on 1 and 8 pairs, and at the rescue budget ----
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Pc, prm, what in ((P, params, "default budget"), (1, params, "default budget"),
                          (8, params, "default budget"),
                          (8, rescue_solver(params), "rescue budget")):
        Mc, vc = M_p[:Pc].contiguous(), vflat_p[:Pc].contiguous()
        s_k = clipper_solve(Mc, vc, n, m, prm)
        s_p = clipper_solve_plain(Mc, vc, n, m, prm)
        torch.cuda.synchronize()
        du = (s_k[0] - s_p[0]).abs().max().item()
        rel = [((a - b).abs() / b.abs().clamp(min=1e-6)).max().item()
               for a, b in zip(s_k[1:], s_p[1:])]
        require(du <= 2e-3 and max(rel) <= 1e-3,
                f"clipper_solve disagrees with its twin on {Pc} pairs, {what}")
        passes = prm.warmup_iters + prm.outer_iters * (prm.inner_iters + 1) + 1
        C = cluster_size(Pc, sms)
        ms = cuda_ms(lambda: clipper_solve(Mc, vc, n, m, prm), reps)
        print(f"clipper_solve, {Pc} pairs, {what} ({passes} matvecs): {C} blocks "
              f"a pair, {Pc * C} blocks, {ms:.4f} ms, "
              f"{passes * nbytes(Mc) / ms / 1e6:.1f} GB/s of M streamed; max |du| "
              f"{du:.3e} (tol 2e-3), max rel d, F, omega {rel[0]:.3e} {rel[1]:.3e} "
              f"{rel[2]:.3e} (tol 1e-3)", flush=True)
        if Pc == P and prm is params:
            s_main, p_main, du_main, ms_main = s_k, s_p, du, ms
    s_k, s_p = s_main, p_main
    R = params.n_restarts
    n_iter = params.outer_iters * (params.inner_iters + 1) + 1
    matvec_rows = params.warmup_iters + R * n_iter
    # yardstick, not a port of the solve: how fast a library call streams
    # the same bytes, one bmm of bf16 u by M per matvec
    ub = torch.rand((P, 1, N), device=dev).to(torch.bfloat16)
    bmm_ms = cuda_ms(lambda: torch.bmm(ub, M_p), reps)
    print(f"yardstick: torch.bmm of bf16 u ({P}, 1, {N}) by M ({P}, {N}, {N}) "
          f"{bmm_ms:.4f} ms, x {matvec_rows} matvecs = {bmm_ms * matvec_rows:.4f} ms "
          f"({nbytes(M_p) / bmm_ms / 1e6:.1f} GB/s)", flush=True)
    records.append(dict(
        name="clipper_solve", max_abs_err=du_main, ms=ms_main,
        plain_ms=cuda_ms(lambda: clipper_solve_plain(M_p, vflat_p, n, m, params),
                         plain_reps),
        bound=bound(nbytes(M_p, vflat_p, *s_k),
                    f32_ops=P * (params.warmup_iters + R * n_iter) * 12.0 * N,
                    bf16_ops=P * matvec_rows * 2.0 * N * N)))

    # ---- round_refine (both on the twin's solve) ----
    u, _, Fv, om = s_p
    r_k = fr.round_refine(M_p, u, Fv, om, n, m, inv)
    r_p = fr.round_refine_plain(M_p, u, Fv, om, n, m, inv)
    torch.cuda.synchronize()
    same = torch.equal(r_k[0], r_p[0]) and torch.equal(r_k[1], r_p[1])
    err = (r_k[0].float() - r_p[0].float()).abs().max().item()
    print(f"round_refine: sel and count equal {same}; counts "
          f"{r_k[1].tolist()}", flush=True)
    require(same, "round_refine disagrees with its twin")
    # what this run's data needs: u, F, omega in, sel and count out, and
    # the K x K entries of M among the K associations rounding selected
    max_steps = min(inv.max_clique, n, m)
    _, k_round = clipper.round_greedy(u.reshape(P, n, m), Fv, max_steps,
                                      inv.rel_thresh)
    m_bytes = 2.0 * float((k_round.double() ** 2).sum())
    records.append(dict(
        name="round_refine", max_abs_err=err,
        ms=cuda_ms(lambda: fr.round_refine(M_p, u, Fv, om, n, m, inv), reps),
        plain_ms=cuda_ms(lambda: fr.round_refine_plain(M_p, u, Fv, om, n, m, inv),
                         plain_reps),
        bound=bound(nbytes(u, Fv, om, *r_k) + m_bytes,
                    f32_ops=P * max_steps * 3.0 * N)))
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) on {P} pairs",
              flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 3: the alignment stage through submap_align
# ---------------------------------------------------------------------------

def run_main_path(runs, maps, workdir, device):
    """submap_align from map pickles with GT pose files; checks the
    artifacts. Returns (launch counts, number of loop closures, seconds)."""
    from roman_tpu_torch.align.submap_align import submap_align
    from roman_tpu_torch.params.submap_align_params import (
        SubmapAlignInputOutput, SubmapAlignParams)
    from roman_tpu_torch.sim import world

    inputs, gts = [], []
    for k, (run, m) in enumerate(zip(runs, maps)):
        pkl = os.path.join(workdir, f"robot{k}.pkl")
        m.save(pkl)
        csv = os.path.join(workdir, f"gt{k}.csv")
        world.write_gt_csv(run, csv)
        gy = os.path.join(workdir, f"gt{k}.yaml")
        with open(gy, "w") as f:
            f.write(f"type: csv\npath: {csv}\n")
        inputs.append(pkl)
        gts.append(gy)
    # the bench world's submaps: capacity 40, radius 15 m, a submap every
    # 10 m, no time threshold, pruning by time
    params = SubmapAlignParams(
        method="roman", semantics_dim=DESC_DIM, submap_max_size=CAPACITY,
        submap_center_time=float("inf"), submap_pruning_method="time",
        cosine_min=0.5, cosine_max=0.9)
    out = os.path.join(workdir, "align")
    io = SubmapAlignInputOutput(inputs=inputs, output_dir=out, run_name="align",
                                input_gt_pose_yaml=gts,
                                robot_names=["robot0", "robot1"])
    reset_launches()
    t0 = time.perf_counter()
    res = submap_align(params, io, chunk_size=KERNEL_PAIRS, device=device)
    seconds = time.perf_counter() - t0
    counts = read_launches()

    n_pairs = int(np.isfinite(res.clipper_num_associations).sum())
    for p in (io.output_g2o, io.output_lc_json, io.output_img, *io.output_submaps):
        require(os.path.exists(p), f"submap_align did not write {p}")
    with open(io.output_img, "rb") as f:
        require(f.read(8) == b"\x89PNG\r\n\x1a\n", "align.png is not a png")
    with open(io.output_g2o) as f:
        lines = f.read().splitlines()
    edges = [ln for ln in lines if ln.startswith("EDGE_SE3:QUAT")]
    lc = [int(ln.split(":")[1]) for ln in lines if ln.startswith("# LC:")]
    with open(io.output_lc_json) as f:
        n_json = len(json.load(f))
    print(f"submap_align: {res.clipper_num_associations.shape[0]} x "
          f"{res.clipper_num_associations.shape[1]} submaps, {n_pairs} pairs "
          f"registered, {len(edges)} loop closures (json {n_json}), "
          f"{seconds:.3f} s wall, launches {counts}", flush=True)
    require(len(edges) > 0 and len(edges) == len(lc) == n_json,
            "align.g2o and align.json disagree or hold no loop closure")
    require(all(len(ln.split()) == 31 for ln in edges),
            "an EDGE line of align.g2o does not have 31 tokens")
    require(min(lc) >= io.lc_association_thresh, "a loop closure under the gate")
    require(all(np.isfinite([float(x) for x in ln.split()[3:]]).all() for ln in edges),
            "a loop-closure edge holds a non-finite number")
    return counts, len(edges), seconds


# ---------------------------------------------------------------------------
# phase 4: the full grid through PairGridRegistrar
# ---------------------------------------------------------------------------

def run_grid(feats, auxs, runs, cfg, repeats=3):
    import torch

    from roman_tpu_torch.align.submap_align import PairGridRegistrar

    pair_i, pair_j = full_grid(feats)
    P = len(pair_i)
    ids = [a["seg_ids"] for a in auxs]

    regs = {}

    def register(chunk, pi=pair_i, pj=pair_j):
        regs[chunk] = PairGridRegistrar(cfg, chunk_size=chunk,
                                        device=feats[0].centers.device)
        return regs[chunk](feats[0], feats[1], ids[0], ids[1], pi, pj)

    register(KERNEL_PAIRS)  # warmup with the full pair list
    torch.cuda.synchronize()
    rates = {}
    for chunk in (KERNEL_PAIRS, 64, 128):
        best = np.inf
        for _ in range(repeats):
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = register(chunk)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rates[chunk] = (P / best, torch.cuda.max_memory_allocated() / 2**30)
        if chunk == KERNEL_PAIRS:
            counts, res_main = read_launches(), res
    print(f"PairGridRegistrar: {P} pairs, "
          + ", ".join(f"chunk {c}: {r:.1f} pairs/s (peak {g:.2f} GiB)"
                      for c, (r, g) in rates.items())
          + f"; launches per grid at chunk {KERNEL_PAIRS} {counts}", flush=True)
    require(all(v > 0 for v in counts.values()), "a kernel was not launched")

    # where the device time goes, over one grid at the main path's chunk
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        register(KERNEL_PAIRS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, copies, sets): the CPU ops that
    # launched them carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile of one grid: wall {wall * 1e3:.1f} ms (profiled), device "
          f"busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}",
          flush=True)
    for key, ms, count in rows[:8]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}", flush=True)
    # the rescue pass launches the solve last, on the unconverged pairs
    solves = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and "clipper_solve_kernel" in e.name),
                    key=lambda e: e.time_range.start)
    n_rescued = regs[KERNEL_PAIRS].rescued
    if n_rescued and solves:
        from roman_tpu_torch.align.clipper_solve import cluster_size
        C = cluster_size(n_rescued, torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"rescue launch: {n_rescued} pairs ({C} blocks a pair), clipper_solve "
              f"{solves[-1].self_device_time_total / 1e3:.3f} ms of device time; "
              f"the other {len(solves) - 1} solve launches "
              f"{sum(e.self_device_time_total for e in solves[:-1]) / 1e3:.3f} ms",
              flush=True)

    # the kernels against the plain path on the card, first 100 pairs
    q = min(QUALITY_PAIRS, P)
    with plain_path():
        ref = register(KERNEL_PAIRS, pair_i[:q], pair_j[:q])
    lc_e = res_main.ok[:q] & (res_main.count[:q] >= 4)
    lc_p = ref.ok & (ref.count >= 4)
    agree = float(np.mean(lc_e == lc_p))
    jac = []
    for k in range(q):
        a, b = res_main.sel[k], ref.sel[k]
        union = int((a | b).sum())
        jac.append(int((a & b).sum()) / union if union else 1.0)
    same_sel = bool((res_main.sel[:q] == ref.sel).all())
    T_ij = gt_relative_poses(auxs, runs, pair_i, pair_j)
    prec, rec = lc_quality_from_lists(res_main.ok, res_main.count,
                                      res_main.T_align, T_ij)
    prec_p, rec_p = lc_quality_from_lists(ref.ok, ref.count, ref.T_align,
                                          T_ij[:q])
    prec_s, rec_s = lc_quality_from_lists(res_main.ok[:q], res_main.count[:q],
                                          res_main.T_align[:q], T_ij[:q])
    print(f"quality: first {q} pairs vs the plain path on the card: "
          f"LC-decision agreement {agree}, association Jaccard mean "
          f"{np.mean(jac):.4f}, identical selections {same_sel}; LC precision/"
          f"recall vs sim GT, full grid {prec:.4f}/{rec:.4f}, first {q} pairs "
          f"kernels {prec_s:.4f}/{rec_s:.4f} plain {prec_p:.4f}/{rec_p:.4f}; "
          f"loop closures {int((res_main.ok & (res_main.count >= 4)).sum())}, "
          f"unconverged after rescue {int((~res_main.converged).sum())}",
          flush=True)
    require(agree == 1.0, "LC decisions differ from the plain path")
    require(np.isfinite(res_main.T_align[res_main.ok]).all(),
            "a registered pair has a non-finite transform")
    return dict(pairs=P, pairs_per_s=rates[KERNEL_PAIRS][0], counts=counts,
                agreement=agree)


# ---------------------------------------------------------------------------
# phase 5: arithmetic-mean fusion drives the solve kernel directly
# ---------------------------------------------------------------------------

def run_arithmetic_mean(feats, auxs, cfg):
    import dataclasses

    import torch

    from roman_tpu_torch.align import registration

    pi, pj = kernel_pairs(auxs, ARITH_PAIRS)
    dev = feats[0].centers.device
    f1 = feats[0].map(lambda x: x[torch.as_tensor(pi, device=dev)])
    f2 = feats[1].map(lambda x: x[torch.as_tensor(pj, device=dev)])
    acfg = dataclasses.replace(cfg, fusion="arithmetic_mean")
    reset_launches()
    out = registration.register_clipper(f1, f2, acfg)
    torch.cuda.synchronize()
    counts = read_launches()
    with plain_path():
        ref = registration.register_clipper(f1, f2, acfg)
    same = torch.equal(out.sel, ref.sel) and torch.equal(out.count, ref.count)
    du = (out.u - ref.u).abs().max().item()
    print(f"arithmetic-mean fusion, {len(pi)} pairs: launches {counts}, sel "
          f"and count equal to the plain path {same}, max |du| {du:.3e}, "
          f"counts {out.count.tolist()}", flush=True)
    require(counts["clipper_solve"] > 0, "the solve kernel was not launched")
    require(same and du <= 2e-3, "arithmetic-mean fusion disagrees with the plain path")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 1
    from roman_tpu_torch.kernels import build

    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    log = build.build_all()
    print(f"built {len(list(build.SRC_DIR.glob('*.cu')))} sources with "
          f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in ptxas_summary(log):
        print("  " + line, flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runs, maps = make_world()
    submaps, feats, auxs, cfg = grid_features(maps, dev)
    print(f"bench world: {len(submaps[0])} x {len(submaps[1])} submaps, "
          f"capacity {CAPACITY}, {DESC_DIM}-d, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    records = check_kernels(feats, auxs, cfg)
    with tempfile.TemporaryDirectory() as workdir:
        main_counts, _, _ = run_main_path(runs, maps, workdir, dev)
    require(all(v > 0 for v in main_counts.values()),
            f"a kernel was not launched on the main path: {main_counts}")
    run_grid(feats, auxs, runs, cfg)
    run_arithmetic_mean(feats, auxs, cfg)

    sources = {"clipper_solve": "roman_tpu_torch/csrc/clipper_solve.cu"}
    replaces = {"clipper_solve": "roman_tpu/align/clipper_pallas.py:50"}
    line = {"kernels": [dict(
        name=r["name"], route="cuda",
        source=sources.get(r["name"], "roman_tpu_torch/csrc/fused_register.cu"),
        replaces=replaces.get(r["name"], "roman_tpu/align/fused_register.py:111"),
        launches=main_counts[r["name"]], max_abs_err=r["max_abs_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
        bound_by=r["bound"][1], library_ms=None) for r in records]}
    print(json.dumps(line), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
