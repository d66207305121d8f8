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
2. holds each of the five kernels against its plain PyTorch twin on the
   card, on 32 pairs (the chunk the main path registers at once; arun_align
   on the fused path's selections of 64, the benchmark grid's chunk), and
   times both: a call of the kernel's wrapper and of the twin with CUDA
   events (``ms``), and the kernel's own device time from torch.profiler
   (``device_ms``, without the host's work between short launches);
   prints the ptxas lines of assoc_terms, build_affinity, round_refine and
   arun_align,
   a yardstick beside assoc_terms (one f32 torch.bmm of the descriptors,
   TF32 off), C and K per pair beside round_refine (entries above the
   rounding's cut, entries it selects), and the bf16 ulp histogram of
   build_affinity against its twin with the nonzero share of M; holds
   and times the CLIPPER solve also on 1 and 8 pairs and at the rescue
   budget (pairs, blocks per pair, live rows of M a pair), beside a
   yardstick: one torch.bmm of bf16 u by M, times the solve's matvec
   count;
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
   CLIPPER solve and round_refine kernels through ``solve_and_round``,
   against the plain path;
6. registers the grid with clipper+prune (the four kernels with no ratio
   and no cosine term and a pruned association mask): pairs/s, launch
   counts, rescued pairs, agreement with the plain path over the first 100
   pairs, and loop-closure precision/recall;
7. registers the grid with ransac (4096 hypotheses, seed 0): pairs/s,
   precision/recall, two card runs equal, and agreement with the port's
   CPU run on the same seed over the first 100 pairs;
8. runs the back half of the demo from phase 3's tree (map pickles and
   align.g2o): odometry g2o files, fusion, combined loop closures, edited
   information, the robust pose-graph solve on the card (wall time, the
   idle share of one profiled solve, two solves bitwise equal, the CPU's
   solve within 1e-2 m with the same rejections), the ATE beside that of
   odometry alone, and the dense graph's solve;
9. runs the device BatchMapper on bench.py's mapping traffic (64 frames
   of 24 observations of 128 points, batches of 16, seed 0): frames/s at
   descriptor widths 64 and 768, peak device memory, the idle share and
   device events of one profiled batch, host agreement against the port's
   host Mapper by bench.py's rule (>= 0.8), and the card's BatchMapper
   against the CPU's (same seg_id, status and sightings per slot, centers
   within 1e-3 m);
10. runs the demo CLI (python -m roman_tpu_torch.demo, in-process) on
   params/demo_sim_device: both robots mapped on the device backend,
   submap_align on the three robot pairs, the sparse robust solve on the
   card and the ATE, with the stage wall times, every launch count set to
   0 just before the call and read just after (all five kernels must
   launch), the output tree of tests/test_e2e_demo.py and the gates of
   tests/test_e2e_demo_device.py (>= 8 loop closures, ATE < 1.0 m); then
   the host backend on robot0's first 300 frames against the device
   backend on the same frames;
11. runs the perception front end on bench.py's perception traffic (8
   frames of 480x640, FastSAM-x at 256x256 and DINOv2-base, 64 masks of
   256 points, seeded random weights): frames/s eager and through
   run_batch's CUDA graph (best of 3 after a warmup; the graph equal to
   the eager program bit for bit), peak device memory, the idle share and
   device events of one profiled batch, each stage's ms and device ms,
   the nets' FLOPs a frame and the share of the bf16 peak; the card
   against the CPU with f32 nets on one frame and bf16 against f32 on the
   card (perception/agreement.py, with the limits below); and CLIP
   ViT-L/14 crop semantics on 2 frames;
12. maps 64 RGB-D frames of 480x640 through MapRunner.run with no front
   end passed (the port's PerceptionFrontend, params/demo/fastsam.yaml)
   and the device mapper, writes map/robot0.pkl and reads it back;
13. writes two robots' ROS1 bags of 64 RGB-D frames of 480x640 (the
   recorded-data path: rgb8 and 16UC1 images, CameraInfo, Odometry, the
   extrinsic on /tf_static, a run-env data.yaml with a TF-resolved
   T_postmultiply) and runs the demo CLI on them a stage at a time, with
   params/demo's nets at full width (seeded random weights), the device
   mapper and 768-d semantics: every artifact, each map's trajectory equal
   to the odometry times the extrinsic within 1e-6, all five kernels
   launched in stage 2, frames/s of mapping and each stage's wall time;
14. drives the reference's per-pair surface on phase 3's tree:
   ROMANRegistration (the grid's configuration, 768-d) and
   DistRegWithPruning on the first 64 submap pairs at their unpadded
   sizes, on the card and on the CPU (associations equal, T_align within
   1e-4, all five kernels launched, ms a register call beside the grid's
   time a pair); a shape sweep (1x1, 1x40, 7x13, 40x40 with 768-d
   descriptors and with none, 100x100) and the largest square the kernels
   take (at a 4-matvec solve budget) against the CPU, and the shapes just
   above the limits of clipper_solve and round_refine refused with
   ValueError before any launch; python -m roman_tpu_torch.demo.loop_closures
   (in-process) on the first two robots of phase 10's demo run, whose EDGE
   lines must equal that run's align stage for the pair (both at
   submap_align's default chunk: the card's sums depend on the chunk),
   all five kernels launched; the viz CLIs as
   processes, which without matplotlib (or cv2) must exit non-zero with an
   ImportError naming it and write nothing, and with it write their files;
15. splits the 506-pair grid over a mesh (parallel.mesh): get_mesh(), the
   visible cards, at 32 pairs a card, and four virtual shards on cuda:0 at
   chunk 128 (each launch 32 pairs, as phase 4's chunk 32) equal to phase
   4's chunk-32 grid byte for byte; four virtual shards at chunk 32
   (launches of 8 pairs) with equal selections, counts and LC decisions
   and T_align within 1e-4; pairs/s of each (a record: virtual shards share
   the card); then dryrun_multichip(1) and dryrun_multichip(4,
   device="cuda:0") (the grid at flagship shapes, a BatchMapper frame a
   robot, a GN step with its edges split), every launch count set to 0
   just before and read just after (all five kernels must launch); and
   the port's native referee (g++, into build/): the serial C++ CLIPPER
   solve on the first 8 bench pairs, its pairs/s and its LC agreement
   with the kernels (a record);
16. runs the adversarial quality sweep (roman_tpu_torch.eval.adversarial)
   at adversarial_eval.py's defaults: eight nuisance scenarios (drift 0.3,
   0.6 and 1.0 m, yaw 180 degrees, 50% duplicates, a symmetric layout, low
   overlap) of 24 positive and 16 negative pairs at capacity 40 with 128-d
   descriptors, through the kernels (every launch count set to 0 just
   before and read just after; all five kernels must launch) and through
   the serial numpy referee: each scenario's P/R for both with Wilson
   intervals and their outcome agreement, the launch counts and the wall;
   then the same pairs through the plain twins on the card, whose LC
   decisions must equal the kernels' on every pair;
17. prints one JSON line of per-kernel numbers (launches on the main path,
   on phases 10 and 13's demo runs, on phase 14's classes and CLI, on
   phase 15's dryrun_multichip and on phase 16's sweep), the card's name
   and power limit again,
   and last {"ok": true, "device": {...}}. No kernel of the port lies on the mapping or perception paths
   (phases 9 and 11-12 launch none).

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
ARUN_PAIRS = 64         # phase 2's arun_align batch: the benchmark grid's chunk
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
    Swaps the four names the registration path looks up for its kernels."""
    from roman_tpu_torch.align import clipper_solve, fused_register, registration

    saved = (registration.fused_register, clipper_solve.clipper_solve,
             fused_register.round_refine, registration.arun_align)
    registration.fused_register = fused_register.fused_register_plain
    clipper_solve.clipper_solve = clipper_solve.clipper_solve_plain
    fused_register.round_refine = fused_register.round_refine_plain
    registration.arun_align = fused_register.arun_align_plain
    try:
        yield
    finally:
        (registration.fused_register, clipper_solve.clipper_solve,
         fused_register.round_refine, registration.arun_align) = saved


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


def check_kernels(feats, auxs, cfg, ptxas=(), reps=10, plain_reps=3):
    """Each kernel and its twin on the same inputs, on the card. Returns
    one record per kernel (without launches). ptxas: the build's summary
    lines, of which those of assoc_terms, build_affinity, round_refine and
    arun_align are repeated."""
    import torch

    from roman_tpu_torch.align import clipper
    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper_solve import (clipper_solve,
                                                     clipper_solve_plain,
                                                     cluster_size)
    from roman_tpu_torch.align.registration import rescue_solver
    from scripts.time_solve import device_ms

    for line in ptxas:
        if line.startswith(("assoc_terms_kernel", "build_affinity_kernel",
                            "round_refine_kernel", "arun_align_kernel")):
            print("ptxas: " + line, flush=True)
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
        device_ms=device_ms(lambda: fr.assoc_terms(*a_args), reps,
                            "assoc_terms_kernel"),
        plain_ms=cuda_ms(lambda: fr.assoc_terms_plain(*a_args), plain_reps),
        bound=bound(n_bytes, f32_ops=ops)))
    # yardstick, not the function: the descriptor dots alone as one f32 bmm
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    d2t = f2.descriptors.transpose(1, 2)
    bmm_ms = device_ms(lambda: torch.bmm(f1.descriptors, d2t), reps, "")
    print(f"assoc_terms: kernel {records[-1]['device_ms']:.4f} ms of device time; "
          f"yardstick: f32 torch.bmm "
          f"of the descriptors ({P}, {n}, {D}) by ({P}, {D}, {m}), TF32 off, "
          f"{bmm_ms:.4f} ms", flush=True)

    # ---- build_affinity (both fed the plain twin's terms) ----
    b_args = (f1.centers, f2.centers, hl_p, nz_p, single_p, vflat_p, inv)
    M_k, M_p = fr.build_affinity(*b_args), fr.build_affinity_plain(*b_args)
    torch.cuda.synchronize()
    ulp = (M_k.view(torch.int16).int() - M_p.view(torch.int16).int()).abs()
    err = (M_k.float() - M_p.float()).abs().max().item()
    hist = {u: int((ulp == u).sum()) for u in (0, 1)}
    hist[">1"] = M_k.numel() - hist[0] - hist[1]
    print(f"build_affinity: max bf16 ulps {ulp.max().item()} (tol 1), entries "
          f"by ulps off {hist} of {M_k.numel()}, max |dM| {err:.3e}; nonzero "
          f"share of M {float((M_k != 0).double().mean()):.6f}", flush=True)
    require(ulp.max().item() <= 1, "build_affinity disagrees with its twin")
    records.append(dict(
        name="build_affinity", max_abs_err=err,
        ms=cuda_ms(lambda: fr.build_affinity(*b_args), reps),
        device_ms=device_ms(lambda: fr.build_affinity(*b_args), reps,
                            "build_affinity_kernel"),
        plain_ms=cuda_ms(lambda: fr.build_affinity_plain(*b_args), plain_reps),
        # the entries that need more than mask tests are a few in ten
        # thousand (the nonzero share above), so the bytes of M bind
        bound=bound(nbytes(*b_args[:6], M_k))))
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
        dms = device_ms(lambda: clipper_solve(Mc, vc, n, m, prm), reps,
                        "clipper_solve_kernel")
        live = (Mc != 0).any(dim=-1).sum(dim=-1)  # rows holding a nonzero, a pair
        print(f"clipper_solve, {Pc} pairs, {what} ({passes} matvecs): {C} blocks "
              f"a pair, {Pc * C} blocks, {ms:.4f} ms a call by CUDA events "
              f"({dms:.4f} ms of device time), live rows of M a pair mean "
              f"{live.double().mean().item():.2f} max {int(live.max())} of {Mc.shape[1]}; max |du| "
              f"{du:.3e} (tol 2e-3), max rel d, F, omega {rel[0]:.3e} {rel[1]:.3e} "
              f"{rel[2]:.3e} (tol 1e-3)", flush=True)
        if Pc == P and prm is params:
            s_main, p_main, du_main, ms_main, dms_main = s_k, s_p, du, ms, dms
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
        name="clipper_solve", max_abs_err=du_main, ms=ms_main, device_ms=dms_main,
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
    # what this run's data needs: u, F, omega in, sel and count out, and
    # the K x K entries of M among the K associations rounding selected;
    # the max of u and the cut test (2 N operations), and in each refinement
    # iteration an add, a test and a count for each of the K x K entries.
    # C entries lie above the cut: the keys the kernel sorts
    max_steps = min(inv.max_clique, n, m)
    _, k_round = clipper.round_greedy(u.reshape(P, n, m), Fv, max_steps,
                                      inv.rel_thresh)
    n_cut = ((u > inv.rel_thresh * u.amax(dim=1, keepdim=True)) & (u > 0)).sum(1)

    def spread(x):
        x = x.double()
        return f"{int(x.min())}/{float(x.median()):g}/{int(x.max())}"

    print(f"round_refine: sel and count equal {same}; counts "
          f"{r_k[1].tolist()}; per pair (min/median/max) C {spread(n_cut)}, "
          f"K {spread(k_round)}", flush=True)
    require(same, "round_refine disagrees with its twin")
    kk_sum = float((k_round.double() ** 2).sum())
    records.append(dict(
        name="round_refine", max_abs_err=err,
        ms=cuda_ms(lambda: fr.round_refine(M_p, u, Fv, om, n, m, inv), reps),
        device_ms=device_ms(lambda: fr.round_refine(M_p, u, Fv, om, n, m, inv),
                            reps, "round_refine_kernel"),
        plain_ms=cuda_ms(lambda: fr.round_refine_plain(M_p, u, Fv, om, n, m, inv),
                         plain_reps),
        bound=bound(nbytes(u, Fv, om, *r_k) + 2.0 * kk_sum,
                    f32_ops=2.0 * P * N + inv.refine_iters * 3.0 * kk_sum)))

    # ---- arun_align (the finish's T_align) on a grid chunk: the fused
    # path's selections of ARUN_PAIRS pairs ----
    ai, aj = kernel_pairs(auxs, ARUN_PAIRS)
    g1 = feats[0].map(lambda x: x[torch.as_tensor(ai, device=dev)].contiguous())
    g2 = feats[1].map(lambda x: x[torch.as_tensor(aj, device=dev)].contiguous())
    sel = fr.fused_register(g1, g2, inv, params)[0]
    t_args = (g1.centers, g2.centers, sel)
    T_k, T_p = fr.arun_align(*t_args), fr.arun_align_plain(*t_args)
    torch.cuda.synchronize()
    T_k, T_p = T_k.double().cpu(), T_p.double().cpu()
    unique = torch.as_tensor(arun_unique(*t_args))
    zero = sel.sum(dim=(1, 2)).cpu() == 0
    R = T_k[:, :3, :3]
    ortho = (R @ R.transpose(1, 2) - torch.eye(3, dtype=torch.float64)).abs().max().item()
    det = (torch.linalg.det(R) - 1.0).abs().max().item()
    err = (R[unique] - T_p[unique, :3, :3]).abs().max().item()
    t_err = (T_k[unique] - T_p[unique]).abs().max().item()
    print(f"arun_align, {ARUN_PAIRS} pairs ({int(unique.sum())} with a unique T, "
          f"{int(zero.sum())} with no selection): max |dR| where unique {err:.3e} "
          f"(tol 1e-4), max |dT| {t_err:.3e}; |R R^T - I| {ortho:.2e}, |det R - 1| "
          f"{det:.2e} (tol 1e-5); identity where nothing is selected "
          f"{bool(torch.equal(T_k[zero], T_p[zero]))}", flush=True)
    require(unique.any() and err <= 1e-4 and ortho <= 1e-5 and det <= 1e-5
            and torch.equal(T_k[zero], torch.eye(4, dtype=torch.float64).expand(
                int(zero.sum()), 4, 4)), "arun_align disagrees with its twin")
    records.append(dict(
        name="arun_align", pairs=ARUN_PAIRS, max_abs_err=err,
        ms=cuda_ms(lambda: fr.arun_align(*t_args), reps),
        device_ms=device_ms(lambda: fr.arun_align(*t_args), reps, "arun_align_kernel"),
        plain_ms=cuda_ms(lambda: fr.arun_align_plain(*t_args), plain_reps),
        # each pair's selection and centers read once, its T written once
        bound=bound(nbytes(*t_args) + ARUN_PAIRS * 16 * 4)))
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms a call by CUDA events "
              f"({r['device_ms']:.4f} ms of device time), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) on {r.get('pairs', P)} pairs",
              flush=True)
    return records


def arun_unique(c1, c2, sel):
    """Pairs whose T_align is unique to f32 precision: count >= 3 and the
    two smallest singular values of the centred H (float64, on the host)
    apart by at least 5% of the largest."""
    c1, c2, sel = (x.double().cpu().numpy() for x in (c1, c2, sel))
    out = np.zeros(len(sel), bool)
    for p in range(len(sel)):
        a, b = np.nonzero(sel[p])
        if len(a) < 3:
            continue
        q1 = c1[p, a] - c1[p, a].mean(0)
        q2 = c2[p, b] - c2[p, b].mean(0)
        s = np.linalg.svd(q1.T @ q2, compute_uv=False)
        out[p] = s[1] - s[2] >= 0.05 * s[0]
    return out


# ---------------------------------------------------------------------------
# phase 3: the alignment stage through submap_align
# ---------------------------------------------------------------------------

ROBOTS = ["robot0", "robot1"]
# the bench world's submaps: capacity 40, radius 15 m, a submap every 10 m,
# no time threshold, pruning by time
MAIN_PATH_PARAMS = dict(
    method="roman", semantics_dim=DESC_DIM, submap_max_size=CAPACITY,
    submap_center_time=float("inf"), submap_pruning_method="time",
    cosine_min=0.5, cosine_max=0.9)


def run_main_path(runs, maps, workdir, device):
    """submap_align from map pickles with GT pose files, laid out as the
    demo's tree (map/<robot>.pkl, align/robot0_robot1/align.*, which phase
    8 goes on from); checks the artifacts. Returns (launch counts, number
    of loop closures, seconds)."""
    from roman_tpu_torch.align.submap_align import submap_align
    from roman_tpu_torch.params.submap_align_params import (
        SubmapAlignInputOutput, SubmapAlignParams)
    from roman_tpu_torch.sim import world

    inputs, gts = [], []
    os.makedirs(os.path.join(workdir, "map"))
    for k, (run, m) in enumerate(zip(runs, maps)):
        pkl = os.path.join(workdir, "map", f"{ROBOTS[k]}.pkl")
        m.save(pkl)
        csv = os.path.join(workdir, f"gt{k}.csv")
        world.write_gt_csv(run, csv)
        gy = os.path.join(workdir, f"gt{k}.yaml")
        with open(gy, "w") as f:
            f.write(f"type: csv\npath: {csv}\n")
        inputs.append(pkl)
        gts.append(gy)
    params = SubmapAlignParams(**MAIN_PATH_PARAMS)
    out = os.path.join(workdir, "align", "_".join(ROBOTS))
    io = SubmapAlignInputOutput(inputs=inputs, output_dir=out, run_name="align",
                                input_gt_pose_yaml=gts, robot_names=ROBOTS)
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
                agreement=agree, result=res_main)


# ---------------------------------------------------------------------------
# phase 5: arithmetic-mean fusion drives the solve and round_refine kernels
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
    require(counts["clipper_solve"] > 0 and counts["round_refine"] > 0,
            "the solve or the round_refine kernel was not launched")
    require(same and du <= 2e-3, "arithmetic-mean fusion disagrees with the plain path")


# ---------------------------------------------------------------------------
# phases 6 and 7: the clipper+prune and ransac methods over the grid
# ---------------------------------------------------------------------------

def time_grid(cfg, feats, ids, pair_i, pair_j, repeats, seed=0):
    """PairGridRegistrar over the pairs at the main path's chunk: one
    warmup call, then pairs/s of the best of `repeats` calls, with the
    launch counts and the registrar of the last call. Returns (pairs/s,
    launches, registrar, result of the last call, results of every timed
    call)."""
    import torch

    from roman_tpu_torch.align.submap_align import PairGridRegistrar

    def register():
        reg = PairGridRegistrar(cfg, chunk_size=KERNEL_PAIRS,
                                device=feats[0].centers.device)
        return reg, reg(feats[0], feats[1], ids[0], ids[1], pair_i, pair_j,
                        seed=seed)

    register()
    torch.cuda.synchronize()
    best, outs = np.inf, []
    for _ in range(repeats):
        reset_launches()
        t0 = time.perf_counter()
        reg, res = register()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        outs.append(res)
    return len(pair_i) / best, read_launches(), reg, res, outs


def lc_report(name, res, ref, runs, auxs, pair_i, pair_j, q):
    """LC-decision agreement of res with ref over the first q pairs, and LC
    precision/recall of res against the sim ground truth (the rule of
    lc_quality_from_lists). Returns (agreement, precision, recall)."""
    lc_a = res.ok[:q] & (res.count[:q] >= 4)
    lc_b = ref.ok[:q] & (ref.count[:q] >= 4)
    agree = float(np.mean(lc_a == lc_b))
    T_ij = gt_relative_poses(auxs, runs, pair_i, pair_j)
    prec, rec = lc_quality_from_lists(res.ok, res.count, res.T_align, T_ij)
    print(f"{name}: LC-decision agreement over the first {q} pairs {agree}; "
          f"LC precision/recall vs sim GT {prec:.4f}/{rec:.4f}; loop closures "
          f"{int((res.ok & (res.count >= 4)).sum())}", flush=True)
    require(np.isfinite(res.T_align[res.ok]).all(),
            f"{name}: a registered pair has a non-finite transform")
    return agree, prec, rec


def run_prune_grid(feats, auxs, runs, cfg, repeats=3):
    """clipper+prune over the full grid: the fused path's four kernels
    with no ratio and no cosine term and a pruned association mask, then
    the roll/pitch check; the rescue re-solves through the same path."""
    import dataclasses

    pcfg = dataclasses.replace(cfg, method="clipper+prune")
    pair_i, pair_j = full_grid(feats)
    ids = [a["seg_ids"] for a in auxs]
    rate, counts, reg, res, _ = time_grid(pcfg, feats, ids, pair_i, pair_j, repeats)
    print(f"clipper+prune grid: {len(pair_i)} pairs, {rate:.1f} pairs/s at chunk "
          f"{KERNEL_PAIRS} (best of {repeats}), launches {counts}, rescued pairs "
          f"{reg.rescued}, unconverged after rescue {int((~res.converged).sum())}",
          flush=True)
    require(all(v > 0 for v in counts.values()),
            f"clipper+prune did not launch every kernel: {counts}")
    q = min(QUALITY_PAIRS, len(pair_i))
    from roman_tpu_torch.align.submap_align import PairGridRegistrar
    with plain_path():
        ref = PairGridRegistrar(pcfg, chunk_size=KERNEL_PAIRS,
                                device=feats[0].centers.device)(
            feats[0], feats[1], ids[0], ids[1], pair_i[:q], pair_j[:q])
    agree, prec, rec = lc_report("clipper+prune vs its plain path", res, ref,
                                 runs, auxs, pair_i, pair_j, q)
    require(agree == 1.0, "clipper+prune LC decisions differ from the plain path")
    return dict(pairs_per_s=rate, counts=counts, rescued=reg.rescued,
                precision=prec, recall=rec)


def run_ransac_grid(feats, auxs, runs, cfg, seed=0):
    """ransac over the full grid (cfg.ransac_iter hypotheses, draws from
    `seed`): two card runs must select the same associations, and the
    first 100 pairs must decide as the port's CPU run on the same seed."""
    import dataclasses

    from roman_tpu_torch.align.submap_align import PairGridRegistrar

    rcfg = dataclasses.replace(cfg, method="ransac")
    pair_i, pair_j = full_grid(feats)
    ids = [a["seg_ids"] for a in auxs]
    rate, counts, _, res, outs = time_grid(rcfg, feats, ids, pair_i, pair_j, 2,
                                           seed=seed)
    same = all(np.array_equal(getattr(outs[0], f), getattr(outs[1], f))
               for f in ("sel", "count", "T_align"))
    print(f"ransac grid: {len(pair_i)} pairs, S = {rcfg.ransac_iter}, seed {seed}, "
          f"{rate:.1f} pairs/s at chunk {KERNEL_PAIRS} (best of 2), launches "
          f"{counts}; two card runs equal {same}", flush=True)
    require(same, "two ransac runs on the card differ")
    q = min(QUALITY_PAIRS, len(pair_i))
    t0 = time.perf_counter()
    cpu = PairGridRegistrar(rcfg, chunk_size=KERNEL_PAIRS, device="cpu")(
        *(f.map(lambda x: x.cpu()) for f in feats), ids[0], ids[1],
        pair_i[:q], pair_j[:q], seed=seed)
    print(f"ransac on the CPU, first {q} pairs: {time.perf_counter() - t0:.1f} s",
          flush=True)
    agree, prec, rec = lc_report("ransac vs the CPU", res, cpu, runs, auxs,
                                 pair_i, pair_j, q)
    require(agree == 1.0, "ransac LC decisions on the card differ from the CPU's")
    return dict(pairs_per_s=rate, precision=prec, recall=rec)


# ---------------------------------------------------------------------------
# phase 8: the back half of the demo from phase 3's artifacts
# ---------------------------------------------------------------------------

def solve_file(final_g2o, out_dir, params, device):
    """rpgo_solve_g2o on `device` (a torch.device) into out_dir; returns
    (result path, diagnostics dict it printed, wall seconds)."""
    import ast
    import io

    import torch

    os.makedirs(out_dir, exist_ok=True)
    from roman_tpu_torch.rpgo.solver import rpgo_solve_g2o

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = rpgo_solve_g2o(final_g2o, out_dir, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("rpgo: ")][-1]
    return result, ast.literal_eval(line.split("edges, ")[1]), seconds


def graph_counts(path):
    from roman_tpu_torch.rpgo.g2o_io import is_loop_closure, parse_g2o

    g = parse_g2o(path)
    n_lc = sum(is_loop_closure(e) for e in g.edges)
    return len(g.vertices), len(g.edges) - n_lc, n_lc


def positions(path):
    from roman_tpu_torch.rpgo.g2o_io import parse_g2o

    g = parse_g2o(path)
    return np.stack([g.vertices[k][:3] for k in sorted(g.vertices)])


def odometry_only_ate(final, time_file, gt):
    """The ATE of the fused graph's odometry alone (its loop closures
    dropped, nothing solved)."""
    from roman_tpu_torch.rpgo.evaluate import evaluate
    from roman_tpu_torch.rpgo.g2o_io import G2OEdge, is_loop_closure

    odom_only = os.path.join(os.path.dirname(final), "odometry_only.g2o")
    with open(final) as f, open(odom_only, "w") as out:
        for line in f:  # vertices and odometry edges: the graph without LCs
            tok = line.split()
            if not tok or tok[0].startswith("#") or (
                    tok[0] == "EDGE_SE3:QUAT" and is_loop_closure(G2OEdge(
                        int(tok[1]), int(tok[2]), np.zeros(7), np.zeros(21)))):
                continue
            out.write(line)
    return evaluate(odom_only, time_file, gt, output_dir=None)


def run_back_half(runs, workdir, device):
    """demo/demo.py:183-302 from map/ and align/robot0_robot1/align.g2o:
    odometry g2o files (sparse at 2.0 m keyframes and dense), fusion,
    combined loop closures, edited loop-closure information, the robust
    solve on the card, and the ATE against the GT csv files; then the same
    solve on the CPU, a second card solve, and the dense graph."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch.params.offline_rpgo_params import OfflineRPGOParams
    from roman_tpu_torch.rpgo.combine_loop_closures import combine_loop_closures
    from roman_tpu_torch.rpgo.evaluate import evaluate
    from roman_tpu_torch.rpgo.extract_odom import roman_map_pkl_to_g2o
    from roman_tpu_torch.rpgo.fusion import create_config, g2o_file_fusion
    from roman_tpu_torch.rpgo.g2o_io import edit_g2o_edge_information
    from roman_tpu_torch.rpgo.solver import RPGOSolverParams
    from roman_tpu_torch.sim import world

    p = OfflineRPGOParams()
    rpgo = os.path.join(workdir, "offline_rpgo")
    gt = {}
    for k, run in enumerate(runs):
        gt[k] = os.path.join(workdir, f"gt{k}.csv")
        world.write_gt_csv(run, gt[k])
    t0 = time.perf_counter()
    for mode in ("sparse", "dense"):
        os.makedirs(os.path.join(rpgo, mode))
    for i, name in enumerate(ROBOTS):
        for mode, kf in (("sparse", 2.0), ("dense", None)):
            roman_map_pkl_to_g2o(
                pkl_file=os.path.join(workdir, "map", f"{name}.pkl"),
                g2o_file=os.path.join(rpgo, mode, f"{name}.g2o"),
                time_file=os.path.join(rpgo, mode, f"{name}.time.txt"),
                robot_id=i, min_keyframe_dist=kf, t_std=p.odom_t_std,
                r_std=p.odom_r_std)
    for mode in ("sparse", "dense"):
        with open(os.path.join(rpgo, mode, "odom_all.time.txt"), "w") as f:
            for name in ROBOTS:
                with open(os.path.join(rpgo, mode, f"{name}.time.txt")) as f2:
                    f.write(f2.read())
    sparse_all = os.path.join(rpgo, "sparse", "odom_all.g2o")
    g2o_file_fusion(create_config(ROBOTS, os.path.join(rpgo, "sparse")),
                    sparse_all, thresh=4)
    dense_all = os.path.join(rpgo, "dense", "odom_and_lc.g2o")
    g2o_file_fusion(create_config(ROBOTS, os.path.join(rpgo, "dense"),
                                  submap_align_dir=os.path.join(workdir, "align"),
                                  align_file_name="align"),
                    dense_all, thresh=4)
    final = os.path.join(rpgo, "odom_and_lc.g2o")
    time_file = os.path.join(rpgo, "sparse", "odom_all.time.txt")
    combine_loop_closures(
        g2o_reference=sparse_all, g2o_extra_lc=dense_all,
        vertex_times_reference=time_file,
        vertex_times_extra_lc=os.path.join(rpgo, "dense", "odom_all.time.txt"),
        output_file=final)
    dense_final = os.path.join(rpgo, "dense", "odom_and_lc_edited.g2o")
    for src, dst in ((final, final), (dense_all, dense_final)):
        with open(src) as f:
            lines = edit_g2o_edge_information(f.readlines(), p.lc_t_std, p.lc_r_std,
                                              loop_closures=True)
        with open(dst, "w") as f:
            for line in lines:
                f.write(line + "\n")
    host_s = time.perf_counter() - t0
    n_v, n_odom, n_lc = graph_counts(final)
    print(f"back half: odometry, fusion, combined loop closures and edited "
          f"information in {host_s:.2f} s (host); sparse graph {n_v} vertices, "
          f"{n_odom} odometry edges, {n_lc} loop closures", flush=True)
    require(n_lc > 0, "the fused graph holds no loop closure")

    params = RPGOSolverParams(gnc_iters=p.gnc_iters, gn_iters=p.gn_iters,
                              pcm_gate=p.pcm_gate)
    cpu = torch.device("cpu")
    res1, diag1, wall1 = solve_file(final, os.path.join(rpgo, "card1"), params, device)
    res2, diag2, wall2 = solve_file(final, os.path.join(rpgo, "card2"), params, device)
    with open(res1, "rb") as f1, open(res2, "rb") as f2:
        bitwise = f1.read() == f2.read()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_file(final, os.path.join(rpgo, "card3"), params, device)
        prof_wall = time.perf_counter() - t0
    # the raw device events (kernels, copies, sets): key_averages() would
    # spend minutes grouping the million host and device events of a solve
    on_device = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in on_device) / 1e6
    n_kernels = len(on_device)
    res_cpu, diag_cpu, wall_cpu = solve_file(final, os.path.join(rpgo, "cpu"),
                                             params, cpu)
    ate = evaluate(res1, time_file, gt, output_dir=None)
    ate_cpu = evaluate(res_cpu, time_file, gt, output_dir=None)
    ate_odom = odometry_only_ate(final, time_file, gt)
    dpos = float(np.abs(positions(res1) - positions(res_cpu)).max())
    print(f"rpgo (sparse): {diag1}; card solve {wall1:.3f} s and {wall2:.3f} s wall, "
          f"two card solves bitwise equal {bitwise}; profiled solve {prof_wall:.3f} s "
          f"wall, device busy {busy:.1f} ms in {n_kernels} device events, idle share "
          f"{max(0.0, 1 - busy / (prof_wall * 1e3)):.3f}; CPU solve {wall_cpu:.3f} s, "
          f"{diag_cpu}, max vertex position difference card vs CPU {dpos:.3e} m; "
          f"ATE {ate:.4f} m (CPU {ate_cpu:.4f} m, odometry alone {ate_odom:.4f} m)",
          flush=True)
    require(bitwise, "two card solves wrote different result.g2o")
    require(diag1 == diag_cpu == diag2,
            "the card and CPU solves reject different loop closures")
    require(dpos <= 1e-2, "card and CPU solves place a vertex more than 1e-2 m apart")
    require(abs(ate - ate_cpu) <= 1e-3, "card and CPU ATE differ by more than 1e-3 m")
    require(all(np.isfinite([ate, ate_cpu, ate_odom, dpos, busy])),
            "a back-half number is not finite")
    require(np.isfinite(positions(res1)).all(), "a solved vertex is not finite")

    dense_time = os.path.join(rpgo, "dense", "odom_all.time.txt")
    res_d, diag_d, wall_d = solve_file(dense_final, os.path.join(rpgo, "dense_card"),
                                       params, device)
    ate_d = evaluate(res_d, dense_time, gt, output_dir=None)
    n_vd, n_od, n_ld = graph_counts(dense_final)
    print(f"rpgo (dense): {n_vd} vertices, {n_od} odometry edges, {n_ld} loop "
          f"closures, {diag_d}; card solve {wall_d:.3f} s wall; ATE {ate_d:.4f} m",
          flush=True)
    require(np.isfinite(ate_d) and np.isfinite(positions(res_d)).all(),
            "the dense solve is not finite")
    return dict(ate=ate, ate_odometry=ate_odom, wall_s=wall1, idle=1 - busy / (prof_wall * 1e3))


# ---------------------------------------------------------------------------
# phase 9: the device mapper on bench.py's mapping traffic
# ---------------------------------------------------------------------------

MAP_FRAMES, MAP_BATCH, MAP_OBS, MAP_POINTS = 64, 16, 24, 128
MAP_WIDTHS = (64, 768)      # bench.py's width, and DINOv2-base's (semantics: dino)


def mapping_params():
    """run_mapping_bench's MapperParams (bench.py:483-484)."""
    from roman_tpu_torch.params.mapper_params import MapperParams

    return MapperParams(min_sightings=2, max_t_no_sightings=2.0,
                        geometric_score_range=(0.1, 1.0))


def feed_stream(mapper, stream, batch=MAP_BATCH):
    times, poses, pts, val, desc, mask = stream
    for s in range(0, len(times), batch):
        e = s + batch
        mapper.update_batch(times[s:e], poses[s:e], pts[s:e], val[s:e], desc[s:e],
                            mask[s:e])


def center_agreement(segs_a, segs_b) -> float:
    """bench.py's referee (:536-543): the share of each map's segments with
    a counterpart within 1 m in the other, averaged over both maps."""
    if not segs_a or not segs_b:
        return 0.0
    ca = np.stack([np.asarray(s.center) for s in segs_a])
    cb = np.stack([np.asarray(s.center) for s in segs_b])
    d = np.linalg.norm(ca[:, None] - cb[None, :], axis=-1)
    return float(0.5 * ((d.min(axis=1) < 1.0).mean() + (d.min(axis=0) < 1.0).mean()))


def device_busy(fn):
    """Run fn once under torch.profiler: (device busy ms from the raw
    device events, number of device events, wall seconds, device ms by
    kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return sum(by_name.values()), len(on_device), wall, by_name


def live_centers(state):
    """Per live pool slot, the mean of its valid points."""
    pts = state.points.cpu().numpy()
    val = state.points_valid.cpu().numpy()
    live = np.flatnonzero(state.status.cpu().numpy() > 0)
    return live, np.stack([pts[i][val[i]].mean(axis=0) if val[i].any()
                           else np.zeros(3) for i in live])


def run_mapping_bench(device, repeats=3):
    """bench.py's run_mapping_bench (bench.py:435-543) on the port's
    BatchMapper: frames/s (best of `repeats` feeds of the 64-frame stream,
    the state reset to the post-warmup snapshot before each) at descriptor
    widths 64 and 768, peak device memory, the idle share and device events
    of one profiled batch; host agreement by bench.py's rule against the
    port's host Mapper; and the card's BatchMapper against the CPU's."""
    import torch

    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.map.batch_mapper import BatchMapper
    from roman_tpu_torch.map.mapper import Mapper
    from roman_tpu_torch.sim.observations import (mapping_bench_stream,
                                                  stream_observations)

    params, cam = mapping_params(), CameraParams.simple()
    out = {}
    reset_launches()
    for D in MAP_WIDTHS:
        stream = mapping_bench_stream(MAP_FRAMES, MAP_OBS, MAP_POINTS, D, seed=SEED)
        mapper = BatchMapper(params, cam, desc_dim=D, obs_capacity=MAP_OBS, device=device)
        t0 = time.perf_counter()
        feed_stream(mapper, stream)          # warmup; populates the map
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        state0 = mapper.state
        torch.cuda.reset_peak_memory_stats()
        best = np.inf
        for _ in range(repeats):
            mapper.state = state0
            t0 = time.perf_counter()
            feed_stream(mapper, stream)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        mapper.state = state0
        busy, n_events, wall, by_name = device_busy(
            lambda: mapper.update_batch(*[x[:MAP_BATCH] for x in stream]))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[D] = dict(fps=MAP_FRAMES / best, peak_mib=peak, idle=1 - busy / (wall * 1e3),
                      events_per_frame=n_events / MAP_BATCH, busy_ms=busy, wall_ms=wall * 1e3)
        print(f"mapping bench, width {D}: {MAP_FRAMES / best:.1f} frames/s (best of "
              f"{repeats}, {best * 1e3:.1f} ms for {MAP_FRAMES} frames; first pass "
              f"{warm:.2f} s), peak device memory {peak:.1f} MiB; one profiled batch of "
              f"{MAP_BATCH} frames: wall {wall * 1e3:.1f} ms, device busy {busy:.2f} ms "
              f"in {n_events} device events ({n_events / MAP_BATCH:.0f} a frame), idle "
              f"share {1 - busy / (wall * 1e3):.3f}; most device time: "
              + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top), flush=True)
    counts = read_launches()

    stream = mapping_bench_stream(MAP_FRAMES, MAP_OBS, MAP_POINTS, MAP_WIDTHS[0], seed=SEED)
    card = BatchMapper(params, cam, desc_dim=MAP_WIDTHS[0], obs_capacity=MAP_OBS,
                       device=device)
    feed_stream(card, stream)
    card_map = card.get_roman_map()
    host = Mapper(params, cam)
    t0 = time.perf_counter()
    for f, obs in enumerate(stream_observations(*stream)):
        host.update(float(stream[0][f]), stream[1][f], obs)
    host_s = time.perf_counter() - t0
    host_map = host.get_roman_map()
    agreement = center_agreement(host_map.segments, card_map.segments)
    cpu = BatchMapper(params, cam, desc_dim=MAP_WIDTHS[0], obs_capacity=MAP_OBS,
                      device="cpu")
    t0 = time.perf_counter()
    feed_stream(cpu, stream)
    cpu_s = time.perf_counter() - t0
    same = {name: bool(torch.equal(getattr(card.state, name).cpu(), getattr(cpu.state, name)))
            for name in ("seg_id", "status", "num_sightings")}
    live_card, c_card = live_centers(card.state)
    live_cpu, c_cpu = live_centers(cpu.state)
    dc = float(np.abs(c_card - c_cpu).max()) if np.array_equal(live_card, live_cpu) else np.inf
    print(f"mapping bench: launches {counts} (no kernel of the port lies on the "
          f"mapping path); host agreement {agreement:.3f} (host Mapper {len(host_map.segments)} "
          f"segments in {host_s:.1f} s, card {len(card_map.segments)}); card against the "
          f"CPU's BatchMapper ({cpu_s:.1f} s): seg_id, status, num_sightings equal "
          f"{same}, {len(live_card)} live slots, max center difference {dc:.3e} m",
          flush=True)
    require(agreement >= 0.8, f"host agreement {agreement:.3f} under 0.8")
    require(all(same.values()), f"the card's and the CPU's pools differ: {same}")
    require(dc <= 1e-3, f"card and CPU segment centers {dc:.3e} m apart (tol 1e-3)")
    require(all(np.isfinite([v["fps"], v["idle"]]).all() for v in out.values()),
            "a mapping bench number is not finite")
    return out, agreement


# ---------------------------------------------------------------------------
# phase 10: the demo's sim chain (params/demo_sim_device) on the card
# ---------------------------------------------------------------------------

DEMO_PARAMS = os.path.join("params", "demo_sim_device")
HOST_WINDOW_FRAMES = 300    # robot0's first 50 s for the host backend


def map_robot(data, mapper_params, name, device, t_window=None):
    """MapRunner.run_observations over one robot's sim stream: (map,
    robot run, frames, mapper seconds, total seconds)."""
    import torch

    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.fastsam_params import FastSAMParams
    from roman_tpu_torch.sim.observations import sim_observation_source

    src, pd, _, robot = sim_observation_source(data["img_data_params"], data["runs"], name)
    tf = None if t_window is None else pd.t0 + t_window
    runner = MapRunner(mapper_params, FastSAMParams(), CameraParams.simple(), pd, tf=tf,
                       dt=float(data["dt"]), device=device)
    t0 = time.perf_counter()
    m = runner.run_observations(src)
    if runner.device is not None and runner.device.type == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return m, robot, len(runner.frame_times()), float(np.sum(runner.times.map_times)), total


DEMO_TREE = ["map/robot0.pkl", "map/robot1.pkl", "map/robot0.time.txt",
             "align/robot0_robot1/align.g2o", "align/robot0_robot1/align.png",
             "offline_rpgo/result.g2o", "offline_rpgo/result.png",
             "offline_rpgo/robot0.csv", "offline_rpgo/ate_rmse.txt", "params/data.yaml"]


def run_demo_cli(device, params_dir, out, *flags):
    """python -m roman_tpu_torch.demo in-process on `device`: (stage wall
    seconds, kernel launches during the call)."""
    from roman_tpu_torch import demo

    argv = ["-p", params_dir, "-o", out, *flags] + (["--cpu"] if device.type == "cpu" else [])
    reset_launches()
    stages = demo.main(argv)
    return stages, read_launches()


def map_seconds(time_txt: str) -> dict:
    """The per-stage totals a mapping run writes to <run>.time.txt."""
    with open(time_txt) as f:
        return {ln.split(":")[0]: float(ln.split("total ")[1].split(" s")[0]) for ln in f}


def run_demo_sim(device, workdir):
    """params/demo_sim_device through the demo CLI: both robots mapped on
    the device backend, submap_align on the demo's three robot pairs, the
    sparse robust solve on the card and the ATE, with every launch count
    set to 0 just before the call and read just after (all five kernels
    must launch), and the gates of tests/test_e2e_demo_device.py. Then the
    host backend on robot0's first HOST_WINDOW_FRAMES frames, against the
    device backend on the same window."""
    import dataclasses

    import yaml

    from roman_tpu_torch.map.roman_map import load_roman_map
    from roman_tpu_torch.params.mapper_params import MapperParams

    pdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), DEMO_PARAMS)
    with open(os.path.join(pdir, "data.yaml")) as f:
        data = yaml.safe_load(f)
    mp = MapperParams.from_yaml(os.path.join(pdir, "mapper.yaml"))
    runs = data["runs"]
    require(mp.mapper_backend == "device", "demo_sim_device does not pick the device mapper")
    out = os.path.join(workdir, "demo_sim")
    stages, counts = run_demo_cli(device, pdir, out)
    print(f"demo CLI, {DEMO_PARAMS}: stage wall times "
          + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
          + f"; launches {counts}", flush=True)
    missing = [p for p in DEMO_TREE if not os.path.exists(os.path.join(out, p))]
    require(not missing, f"the demo CLI did not write {missing}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel was not launched on the demo CLI's path: {counts}")
    for name in runs:
        m = load_roman_map(os.path.join(out, "map", f"{name}.pkl"))
        sec = map_seconds(os.path.join(out, "map", f"{name}.time.txt"))
        n = len(m.times)
        print(f"demo_sim_device map {name}: {n} frames, {len(m.segments)} segments; "
              f"mapper {sec['map']:.2f} s ({n / sec['map']:.1f} frames/s), with the "
              f"observation stream {sec['total']:.2f} s", flush=True)
        require(len(m.segments) > 0 and np.isfinite(
            np.stack([s.center for s in m.segments])).all(), f"{name}'s map is empty or "
            "not finite")
    with open(os.path.join(out, "align", "_".join(runs), "align.g2o")) as f:
        n_lc = sum(ln.startswith("EDGE_SE3:QUAT") for ln in f)
    with open(os.path.join(out, "offline_rpgo", "ate_rmse.txt")) as f:
        ate = float(f.read())
    rpgo = os.path.join(out, "offline_rpgo")
    gt = {k: os.path.join(out, "gt", f"{name}.yaml") for k, name in enumerate(runs)}
    ate_odom = odometry_only_ate(os.path.join(rpgo, "odom_and_lc.g2o"),
                                 os.path.join(rpgo, "sparse", "odom_all.time.txt"), gt)
    print(f"demo_sim_device: {n_lc} loop closures (gate >= 8), ATE {ate:.4f} m "
          f"(gate < 1.0; odometry alone {ate_odom:.4f} m)", flush=True)
    require(n_lc >= 8, f"only {n_lc} loop closures between the robots (gate 8)")
    require(np.isfinite([ate, ate_odom]).all() and np.isfinite(
        positions(os.path.join(rpgo, "result.g2o"))).all(), "a back-half number is not finite")
    require(ate < 1.0, f"ATE {ate:.4f} m (gate 1.0 m)")

    t_window = HOST_WINDOW_FRAMES * float(data["dt"])
    host_params = dataclasses.replace(mp, mapper_backend="host")
    hm, _, n, host_map_s, _ = map_robot(data, host_params, runs[0], device, t_window)
    dm, _, _, dev_map_s, _ = map_robot(data, mp, runs[0], device, t_window)
    agreement = center_agreement(hm.segments, dm.segments)
    print(f"demo_sim_device {runs[0]}, first {n} frames: host backend {host_map_s:.2f} s "
          f"({n / host_map_s:.1f} frames/s, {len(hm.segments)} segments), device backend "
          f"{dev_map_s:.2f} s ({n / dev_map_s:.1f} frames/s, {len(dm.segments)} segments), "
          f"agreement {agreement:.3f}", flush=True)
    require(agreement >= 0.8, f"host/device agreement {agreement:.3f} under 0.8")
    return dict(stages=stages, launches=counts, n_lc=n_lc, ate=ate, ate_odometry=ate_odom,
                host_fps=n / host_map_s, agreement=agreement, out=out, runs=runs,
                params=pdir)


# ---------------------------------------------------------------------------
# phase 11: the perception front end on bench.py's perception traffic
# ---------------------------------------------------------------------------

PERC_FRAMES, PERC_H, PERC_W = 8, 480, 640
PERC_ARCHS = dict(seg_arch="fastsam-x", vit_arch="dinov2-base")
CLIP_FRAMES = 2
CLIP_CFG = None             # None: CLIP ViT-L/14, the reference's
# card against CPU (f32 nets) and bf16 against f32 on the card: the limits
NET_REL_TOL = 1e-3          # head outputs, prototypes: max |d| / max |x|
VIT_REL_TOL = 1e-4          # patch tokens
KNIFE_EDGE = 1e-4           # |mask logit| below this may fall either way
POINT_TOL = 1e-3            # m, valid points of proposals with equal masks
COS_CPU = 0.9999            # embeddings and frame descriptors, card vs CPU
MATCHED_CPU = 0.9           # share of proposals (by anchor) found in both runs
MATCHED_BF16, IOU_BF16, COS_BF16, FD_COS_BF16 = 0.5, 0.8, 0.99, 0.99


def perception_params(**kw):
    """run_perception_bench's FastSAMParams (bench.py:545-568)."""
    from roman_tpu_torch.params.fastsam_params import FastSAMParams

    base = dict(imgsz=(256, 256), batch_frames=PERC_FRAMES, max_masks_per_frame=64,
                max_points_per_mask=256, **PERC_ARCHS)
    base.update(kw)
    return FastSAMParams(**base)


def perception_frames(seed=SEED):
    """run_perception_bench's frames: images uniform in [0, 1), depths
    uniform in [1, 6) m."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(PERC_FRAMES, PERC_H, PERC_W, 3)).astype(np.float32)
    depths = rng.uniform(1.0, 6.0, size=(PERC_FRAMES, PERC_H, PERC_W)).astype(np.float32)
    return images, depths


def net_flops(fe, frames):
    """FLOPs of one frame through the segmentation net and the ViT,
    counted from the shapes of their products and convolutions."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from roman_tpu_torch.ops.image import resize_bilinear
    from roman_tpu_torch.perception import dinov2
    from roman_tpu_torch.perception.wrapper import _r32

    img, _ = fe.inputs(*[x[:1] for x in frames])
    p, c = fe.params, fe.vit_cfg.patch
    seg_in = resize_bilinear(img, (_r32(p.imgsz[0]), _r32(p.imgsz[1])))
    vit_in = dinov2.normalize(resize_bilinear(img, (PERC_H // c * c, PERC_W // c * c)),
                              dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD)
    out = {}
    for name, fn in (("seg", lambda: fe.seg_model(seg_in)),
                     ("vit", lambda: fe.vit_model(vit_in))):
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn()
        out[name] = float(counter.get_total_flops())
    return out


def stage_times(fe, frames):
    """The batch program's stages, each run alone on the batch's own
    intermediate tensors: ms a call by CUDA events (3 calls after a
    warmup), and device ms and events of one call from the profiler."""
    import torch

    from roman_tpu_torch.ops.image import resize_bilinear, resize_nearest
    from roman_tpu_torch.perception import dinov2, fastsam
    from roman_tpu_torch.perception.vit import attention_core
    from roman_tpu_torch.perception.wrapper import _r32, erode_masks

    p = fe.params
    img, dep = fe.inputs(*frames)
    hw = (_r32(p.imgsz[0]), _r32(p.imgsz[1]))
    K = p.max_masks_per_frame
    with torch.no_grad():
        seg_in = resize_bilinear(img, hw)
        out = fe.seg_model(seg_in)
        idx, boxes, _, coeffs, keep = fastsam.select_proposals(out, fe.seg_cfg, hw, p.conf,
                                                               p.iou, K)
        masks, _, _ = fe.segment(img)
        c = fe.vit_cfg
        gh, gw = PERC_H // c.patch * c.patch, PERC_W // c.patch * c.patch
        vit_in = dinov2.normalize(resize_bilinear(img, (gh, gw)), dinov2.IMAGENET_MEAN,
                                  dinov2.IMAGENET_STD)
        n_tok = (gh // c.patch) * (gw // c.patch) + 1
        q, k, v = (torch.randn((img.shape[0], c.heads, n_tok, c.width // c.heads),
                               device=img.device).to(c.dtype) for _ in range(3))
        stages = {
            "FastSAM convolutions (the net)": lambda: fe.seg_model(seg_in),
            "decode + NMS loop": lambda: fastsam.select_proposals(out, fe.seg_cfg, hw, p.conf,
                                                                  p.iou, K),
            "mask assembly + resize": lambda: resize_nearest(fastsam.assemble_masks(
                out["proto"], coeffs, boxes, hw).float(), (PERC_H, PERC_W)),
            "ViT (products + attention)": lambda: fe.vit_model(vit_in),
            f"attention alone ({c.depth} layers)":
                lambda: [attention_core(q, k, v) for _ in range(c.depth)],
            "mask filters": lambda: fe.mask_filters(masks, keep),
            "erosion (strided)": lambda: erode_masks(masks, 2 * p.erosion_size + 1,
                                                     stride=p.pcd_stride),
            "lifting (erosion, top_k, voxel downsample)": lambda: fe.lift(masks, dep),
        }
        res = {}
        for name, fn in stages.items():
            busy, n_ev, _, _ = device_busy(fn)
            res[name] = (cuda_ms(fn, 3), busy, n_ev)
    return res


def compare_runs(fe_a, fe_b, frames, label):
    """Frame 0 through two front ends with the same weights
    (perception.agreement): printed, and returned."""
    from roman_tpu_torch.perception.agreement import front_end_agreement

    res = front_end_agreement(fe_a, fe_b, *[x[:1] for x in frames], knife_edge=KNIFE_EDGE)
    print(f"perception, {label}: nets max rel |d| {res['net_rel']:.3e} (heads, prototypes), "
          f"{res['vit_rel']:.3e} (patch tokens); proposals matched by anchor "
          f"{res['matched']:.3f}, valid equal {res['valid_equal']:.3f}, mask IoU (camera "
          f"frame, every {fe_a.params.mask_downsample_factor}th pixel) {res['iou']:.4f}; "
          f"masks in the net's frame: {res['diff_pixels']} pixels differ, "
          f"{res['diff_off_edge']} of them off the knife edge (|logit| < {KNIFE_EDGE:g}: "
          f"{res['edge_pixels']} of {res['pixels']} pixels); {res['same']} proposals with "
          f"equal masks: valid equal {res['valid_equal_same']}, points valid equal "
          f"{res['points_valid_equal']}, max point |d| {res['point_err']:.3e} m, min "
          f"embedding cosine {res['emb_cos_min_same']:.6f}; mean embedding cosine "
          f"{res['emb_cos_mean']:.6f}; frame descriptor cosine {res['fd_cos']:.6f}", flush=True)
    return res


def run_perception_bench(device, repeats=3):
    """bench.py's run_perception_bench (bench.py:545-568) on the port's
    front end: frames/s (best of `repeats` after a warmup), peak device
    memory, the idle share and device events of one profiled batch, the
    stages' device ms, the nets' FLOPs per frame and the share of the bf16
    peak; then the card against the CPU with f32 nets on one frame, bf16
    against f32 on the card, and CLIP crop semantics on 2 frames."""
    import dataclasses

    import torch

    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.perception import clip as clip_mod
    from roman_tpu_torch.perception.wrapper import SEG_ARCHS, VIT_ARCHS, PerceptionFrontend

    cam = CameraParams.simple(width=PERC_W, height=PERC_H)
    params = perception_params()
    frames = perception_frames()
    reset_launches()
    t0 = time.perf_counter()
    fe = PerceptionFrontend(params, cam, device=device)
    build_s = time.perf_counter() - t0
    K = params.max_masks_per_frame

    def batch(graph):
        out = fe.program(*fe.inputs(*frames), graph=graph)
        return {k: v.cpu().numpy() for k, v in out.items()}

    res = {}
    for graph in (False, True):   # the eager program, then run_batch's graph replay
        t0 = time.perf_counter()
        out = batch(graph)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = batch(graph)
            best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy, n_events, wall, by_name = device_busy(lambda: batch(graph))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        res[graph] = dict(fps=PERC_FRAMES / best, peak=peak, idle=1 - busy / (wall * 1e3),
                          events=n_events, busy=busy, out=out)
        print(f"perception bench, {'graph replay (run_batch)' if graph else 'eager'} "
              f"({params.seg_arch}, {params.vit_arch}, {PERC_FRAMES} frames of "
              f"{PERC_H}x{PERC_W}, imgsz {params.imgsz}, {K} masks, "
              f"{params.max_points_per_mask} points): {PERC_FRAMES / best:.2f} frames/s (best "
              f"of {repeats}, {best * 1e3:.1f} ms a batch; first batch {first:.2f} s; nets "
              f"built in {build_s:.1f} s), peak device memory {peak:.1f} MiB; one profiled "
              f"batch: wall {wall * 1e3:.1f} ms, device busy {busy:.2f} ms in {n_events} "
              f"device events, idle share {1 - busy / (wall * 1e3):.3f}; valid masks "
              f"{int(out['valid'].sum())} of {out['valid'].size}; most device time: "
              + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in top), flush=True)
    same = {k: bool(np.array_equal(res[True]["out"][k], res[False]["out"][k]))
            for k in res[True]["out"]}
    counts = read_launches()
    print(f"perception bench: graph replay equals the eager program {same}; launches "
          f"{counts} (no kernel of the port lies on this path)", flush=True)
    require(all(same.values()), "the graph replay differs from the eager program")
    fps, peak, busy = res[True]["fps"], res[True]["peak"], res[True]["busy"]
    out = fe.run_batch(*frames)
    require(np.isfinite(out.points).all() and np.isfinite(out.embeddings).all()
            and np.isfinite(out.frame_descriptors).all(), "a front-end output is not finite")
    require(out.embeddings.shape == (PERC_FRAMES, K, fe.embedding_dim),
            f"embeddings of shape {out.embeddings.shape}")
    require(out.valid.any(), "no valid mask in the perception batch")
    stages = stage_times(fe, frames)
    print("perception stages, a batch (ms by CUDA events; device ms and events from the "
          "profiler): " + "; ".join(f"{n} {ms:.2f} ms ({busy:.2f} ms, {ev})"
                                    for n, (ms, busy, ev) in stages.items()), flush=True)
    flops = net_flops(fe, frames)
    per_frame = flops["seg"] + flops["vit"]
    share = per_frame * fps / BF16_FLOPS
    print(f"perception FLOPs a frame (counted from shapes): segmentation "
          f"{flops['seg'] / 1e9:.1f} G, ViT {flops['vit'] / 1e9:.1f} G, total "
          f"{per_frame / 1e9:.1f} G; at {fps:.2f} frames/s that is "
          f"{per_frame * fps / 1e12:.1f} TFLOP/s, {share:.4f} of the bf16 dense peak "
          f"({BF16_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
    del fe

    f32 = dict(seg_cfg=dataclasses.replace(SEG_ARCHS[params.seg_arch], dtype=torch.float32),
               vit_cfg=dataclasses.replace(VIT_ARCHS[params.vit_arch], dtype=torch.float32))
    card32 = PerceptionFrontend(params, cam, device=device, **f32)
    cpu32 = PerceptionFrontend(params, cam, device="cpu", **f32)
    cpu = compare_runs(card32, cpu32, frames, "card against the CPU, f32 nets, frame 0")
    del cpu32
    require(cpu["net_rel"] <= NET_REL_TOL and cpu["vit_rel"] <= VIT_REL_TOL,
            "the card's nets disagree with the CPU's")
    require(cpu["matched"] >= MATCHED_CPU, "the card's proposals disagree with the CPU's")
    require(cpu["diff_off_edge"] == 0 and cpu["same"] >= cpu["matched"] * K / 2
            and cpu["valid_equal_same"] and cpu["points_valid_equal"]
            and cpu["point_err"] <= POINT_TOL and cpu["emb_cos_min_same"] >= COS_CPU
            and cpu["fd_cos"] >= COS_CPU, "the card's masks, points or embeddings "
            "disagree with the CPU's")
    card16 = PerceptionFrontend(params, cam, device=device)
    b16 = compare_runs(card16, card32, frames, "bf16 against f32 nets on the card, frame 0")
    del card16, card32
    require(b16["matched"] >= MATCHED_BF16 and b16["iou"] >= IOU_BF16
            and b16["emb_cos_mean"] >= COS_BF16 and b16["fd_cos"] >= FD_COS_BF16,
            "the bf16 front end strays from the f32 one")

    # a side check that the crops run and stay finite; the benchmark's cell
    # frontend_clip measures CLIP ViT-L/14 through MapRunner.run and holds
    # its embeddings against benchmark/reference/clip_f32.py
    cp = perception_params(semantics="clip", batch_frames=CLIP_FRAMES)
    fe = PerceptionFrontend(cp, cam, device=device,
                            clip_cfg=CLIP_CFG or clip_mod.CLIP_VIT_L14)
    two = [x[:CLIP_FRAMES] for x in frames]
    fe.run_batch(*two)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fe.run_batch(*two)
    clip_s = time.perf_counter() - t0
    finite = bool(np.isfinite(out.embeddings).all())
    print(f"perception, semantics clip ({fe.clip_cfg.width}-wide, {fe.clip_cfg.depth} layers, "
          f"{CLIP_FRAMES * K} crops of {fe.clip_cfg.img_size}): {CLIP_FRAMES / clip_s:.2f} "
          f"frames/s, embeddings {out.embeddings.shape}, finite {finite}", flush=True)
    require(finite and out.embeddings.shape[-1] == fe.embedding_dim,
            "the CLIP embeddings are not finite")
    return dict(fps=fps, fps_eager=res[False]["fps"], peak_mib=peak, idle=res[True]["idle"],
                events=res[True]["events"], flops=per_frame, cpu=cpu, bf16=b16,
                clip_fps=CLIP_FRAMES / clip_s)


# ---------------------------------------------------------------------------
# phase 12: RGB-D frames to a map on the card, through MapRunner.run
# ---------------------------------------------------------------------------

RGBD_FRAMES, RGBD_DT = 64, 0.25
DEMO_FASTSAM = os.path.join("params", "demo", "fastsam.yaml")


def rgbd_stream(seed=SEED):
    """tests/test_npz_mapping.py::_make_archive's frames at the camera's
    full size: seeded uint8 images, depth 3 m with a near box at 1.5 m,
    and a TUM-style slow forward trajectory (x = 0.2 t)."""
    n, H, W = RGBD_FRAMES, PERC_H, PERC_W
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, size=(n, H, W, 3)).astype(np.uint8)
    depths = np.full((n, H, W), 3.0, np.float32)
    depths[:, 30 * H // 96:60 * H // 96, 40 * W // 128:70 * W // 128] = 1.5
    times = np.arange(n) * RGBD_DT
    poses = np.stack([np.eye(4)] * n)
    poses[:, 0, 3] = 0.2 * times
    return images, depths, times, poses


def run_rgbd_mapping(device, workdir):
    """MapRunner.run with the device mapper and no front end passed: the
    port's PerceptionFrontend (params/demo/fastsam.yaml) maps the RGB-D
    stream; the map is written to map/robot0.pkl and read back."""
    import dataclasses

    import torch

    from roman_tpu_torch.data.camera import CameraParams
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.map.roman_map import load_roman_map
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.fastsam_params import FastSAMParams
    from roman_tpu_torch.params.mapper_params import MapperParams
    from roman_tpu_torch.perception.wrapper import PerceptionFrontend

    pdir = os.path.dirname(os.path.abspath(__file__))
    fs = FastSAMParams.from_yaml(os.path.join(pdir, DEMO_FASTSAM))
    fs = dataclasses.replace(fs, **PERC_ARCHS)
    mp = MapperParams(min_sightings=1, max_t_no_sightings=2.0,
                      geometric_score_range=(0.05, 1.0), mapper_backend="device")
    images, depths, times, poses = rgbd_stream()
    pd = PoseData.from_times_and_poses(times, poses)
    runner = MapRunner(mp, fs, CameraParams.simple(width=PERC_W, height=PERC_H), pd,
                       tf=times[-1] + RGBD_DT, dt=RGBD_DT, device=device)

    def get_frames(ts):
        idx = np.rint(np.asarray(ts) / RGBD_DT).astype(int)
        return images[idx], depths[idx]

    reset_launches()
    t0 = time.perf_counter()
    m = runner.run(get_frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    n = len(runner.frame_times())
    path = os.path.join(workdir, "map", "robot0.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    m.save(path)
    back = load_roman_map(path)
    dims = {np.asarray(s.semantic_descriptor).shape for s in back.segments}
    percep, mapping = float(np.sum(runner.times.fastsam_times)), float(
        np.sum(runner.times.map_times))
    print(f"rgbd mapping ({fs.seg_arch}, {fs.vit_arch}, {n} frames of {PERC_H}x{PERC_W}, "
          f"batches of {fs.batch_frames}): front end {n / percep:.2f} frames/s ({percep:.2f} "
          f"s), mapper {n / mapping:.2f} frames/s ({mapping:.2f} s), map stage {wall:.2f} s "
          f"wall (the front end built on first use); {len(m.segments)} segments, read back "
          f"{len(back.segments)} from {os.path.relpath(path, workdir)}, descriptor shapes "
          f"{sorted(dims)}; launches {counts}", flush=True)
    require(isinstance(runner.frontend, PerceptionFrontend)
            and runner.frontend.device.type == device.type,
            "MapRunner.run did not build the front end on its device")
    require(len(back.segments) > 0 and len(back.segments) == len(m.segments),
            "the RGB-D map is empty or did not read back")
    require(dims == {(runner.frontend.embedding_dim,)}, f"descriptor shapes {dims}")
    require(np.isfinite(np.stack([s.center for s in back.segments])).all(),
            "a segment center is not finite")
    return dict(frames=n, percep_fps=n / percep, map_fps=n / mapping, wall=wall,
                segments=len(m.segments))


# ---------------------------------------------------------------------------
# phase 13: the demo CLI on ROS1 bags, at full width
# ---------------------------------------------------------------------------

BAG_RUNS, BAG_FRAMES, BAG_DT = ["r0", "r1"], 64, 0.25
BAG_MAPPER = dict(min_sightings=1, max_t_no_sightings=2.0,
                  geometric_score_range=[0.05, 1.0], mapper_backend="device")
DEMO_SUBMAP_ALIGN = os.path.join("params", "demo", "submap_align.yaml")


def run_demo_bag(device, workdir):
    """Two robots' ROS1 bags (rgb8 and 16UC1 frames of PERC_H x PERC_W,
    CameraInfo, Odometry and the base -> camera extrinsic on /tf_static,
    written by the port's BagWriter) through the demo CLI with
    params/demo's nets at full width (seeded random weights), the device
    mapper and params/demo's alignment (768-d semantics) without its submap
    descriptor gate: one call a stage (--skip-* flags), so the
    kernels' launches are read around stage 2 alone. Gates: every artifact
    exists, each map's trajectory is the bag's odometry times the TF
    extrinsic within 1e-6, all five kernels launch during stage 2."""
    import yaml

    from roman_tpu_torch.map.roman_map import load_roman_map
    from roman_tpu_torch.sim.rgbd_bags import write_bag_world

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, DEMO_FASTSAM)) as f:
        fastsam = dict(yaml.safe_load(f), **PERC_ARCHS)
    with open(os.path.join(here, DEMO_SUBMAP_ALIGN)) as f:
        submap_align = yaml.safe_load(f)
    # random nets give frame descriptors no meaning, and the submap
    # descriptor gate could drop every pair before registration
    submap_align["submap_descriptor"] = None
    root = os.path.join(workdir, "bags")
    os.makedirs(root)
    t0 = time.perf_counter()
    params, odoms, T_base_cam = write_bag_world(
        root, BAG_RUNS, BAG_FRAMES, PERC_H, PERC_W, BAG_DT, SEED, fastsam, BAG_MAPPER,
        submap_align)
    bag_mb = sum(os.path.getsize(os.path.join(root, f"{r}.bag")) for r in BAG_RUNS) / 2**20
    print(f"bag demo: wrote {len(BAG_RUNS)} bags of {BAG_FRAMES} frames of {PERC_H}x{PERC_W} "
          f"({bag_mb:.1f} MiB) in {time.perf_counter() - t0:.2f} s", flush=True)
    out = os.path.join(workdir, "demo_bag")
    stages, launches = {}, {}
    for stage, skips in (("map", ("--skip-align", "--skip-rpgo")),
                         ("align", ("--skip-map", "--skip-rpgo")),
                         ("rpgo", ("--skip-map", "--skip-align"))):
        st, launches[stage] = run_demo_cli(device, params, out, *skips, "--skip-self-lc")
        stages.update(st)
    pair = "_".join(BAG_RUNS)
    tree = [f"map/{r}.pkl" for r in BAG_RUNS] + [
        f"map/{BAG_RUNS[0]}.time.txt", f"align/{pair}/align.g2o", f"align/{pair}/align.png",
        f"align/{pair}/align.pkl", "offline_rpgo/result.g2o", "offline_rpgo/result.png",
        f"offline_rpgo/{BAG_RUNS[0]}.csv", "offline_rpgo/ate_rmse.txt", "params/data.yaml"]
    missing = [p for p in tree if not os.path.exists(os.path.join(out, p))]
    require(not missing, f"the bag demo did not write {missing}")
    frames, worst = 0, 0.0
    for run in BAG_RUNS:
        m = load_roman_map(os.path.join(out, "map", f"{run}.pkl"))
        idx = np.round(np.asarray(m.times) / BAG_DT).astype(int)
        err = float(np.abs(m.trajectory - (odoms[run] @ T_base_cam)[idx]).max())
        worst = max(worst, err)
        frames += len(m.times)
        sec = map_seconds(os.path.join(out, "map", f"{run}.time.txt"))
        print(f"bag demo map {run}: {len(m.times)} frames, {len(m.segments)} segments; "
              f"front end {len(m.times) / sec['fastsam']:.2f} frames/s, mapper "
              f"{len(m.times) / sec['map']:.2f} frames/s; trajectory vs odometry x "
              f"extrinsic max |d| {err:.3e}", flush=True)
        require(len(m.times) >= BAG_FRAMES - 2, f"{run}'s map holds {len(m.times)} frames")
    with open(os.path.join(out, "offline_rpgo", "ate_rmse.txt")) as f:
        ate = float(f.read())
    print(f"bag demo ({fastsam['seg_arch']}, {fastsam['vit_arch']}, "
          f"{submap_align['semantics_dim']}-d): stage wall times "
          + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
          + f"; mapping {frames / stages['map']:.2f} frames/s over both robots; ATE "
          f"{ate:.4f} m (random nets); launches by stage {launches}; {nvidia_smi()}",
          flush=True)
    require(worst <= 1e-6, f"a map's trajectory is {worst:.3e} from the bag's odometry")
    require(np.isfinite(ate), "the bag demo's ATE is not finite")
    require(all(v > 0 for v in launches["align"].values()),
            f"a kernel was not launched in the bag demo's stage 2: {launches['align']}")
    return dict(stages=stages, launches=launches["align"], frames=frames)


# ---------------------------------------------------------------------------
# phase 14: the per-pair surface
# ---------------------------------------------------------------------------

PER_PAIR_PAIRS = 64
# n x m of the shape sweep, each with 768-d descriptors and with none (the
# last only with descriptors)
SWEEP = ((1, 1), (1, 40), (7, 13), (40, 40), (100, 100))
# the solve budget at the largest shape: 4 streams of its M (about 0.6 GB)
# instead of the default's 51
LARGEST_SOLVER = dict(warmup_iters=1, outer_iters=1, inner_iters=1)
VIZ_CLIS = ("map_viz", "o3d_viz", "submap_viz", "association_vid",
            "association_vid --camera-video")


def per_pair_classes(cfg, device):
    """ROMANRegistration at the grid's configuration (gravity, volume, pca,
    768-d semantics, its cos_min and cos_max) and DistRegWithPruning at
    the clipper+prune grid's, on device."""
    from roman_tpu_torch.align.dist_reg_with_pruning import DistRegWithPruning
    from roman_tpu_torch.align.roman_registration import (ROMANParams,
                                                          ROMANRegistration)

    roman = ROMANRegistration(ROMANParams(
        gravity=True, volume=True, pca=True, semantics_dim=DESC_DIM,
        sigma=cfg.sigma, epsilon=cfg.epsilon, mindist=cfg.mindist,
        cos_min=cfg.cos_min, cos_max=cfg.cos_max), device=device)
    prune = DistRegWithPruning(cfg.sigma, cfg.epsilon, mindist=cfg.mindist,
                               shape_epsilon=cfg.epsilon_shape,
                               cos_min=cfg.cos_min, device=device)
    return {"ROMANRegistration": roman, "DistRegWithPruning": prune}


def same_registration(reg_a, reg_b, s1, s2, what: str):
    """Both registrations of one pair, each through its engine on its own
    device (what register returns, plus the engine's transform), give
    equal associations and, where a transform is defined, the engine's
    T_align within 1e-4 (the card's own, not the host's Arun on the
    associations); with fewer associations than dim, T_align raises.
    Returns the associations and the transforms' largest difference (0
    where none was compared)."""
    from roman_tpu_torch.align.object_registration import \
        InsufficientAssociationsException

    res = [reg._solve(*reg._features(s1, s2)) for reg in (reg_a, reg_b)]
    A, B = (np.argwhere(r.sel.cpu().numpy()) for r in res)
    require(A.shape == B.shape and np.array_equal(A, B),
            f"{what}: associations differ, {A.tolist()} against {B.tolist()}")
    err = 0.0
    if len(A) >= reg_a.dim:
        Ta, Tb = (r.T_align.cpu().numpy() for r in res)
        err = float(np.abs(Ta - Tb).max())
        require(err <= 1e-4, f"{what}: the engine's T_align differs by {err:.3g}")
    elif len(A):
        for reg, X in ((reg_a, A), (reg_b, B)):
            try:
                reg.T_align(s1, s2, X)
            except InsufficientAssociationsException:
                continue
            raise AssertionError(f"{what}: T_align of {len(X)} associations did not raise")
    return A, err


def sweep_pair(n, m, desc_dim, seed):
    """n and m objects: the first min(n, m) of the second map are the
    first map's under a yaw and a shift, with 2 cm of noise, and their
    descriptors (desc_dim of them, or none) noisy copies; the rest are
    drawn anew."""
    from roman_tpu_torch.map.roman_map import SegmentData

    rng = np.random.default_rng(seed)
    k = min(n, m)

    def objects(count):
        c = rng.uniform(-20.0, 20.0, (count, 3)) * np.array([1.0, 1.0, 0.1])
        return (c, rng.uniform(0.5, 4.0, count), rng.dirichlet(np.ones(3), count),
                rng.uniform(0.2, 2.0, (count, 3)),
                rng.normal(size=(count, desc_dim)) if desc_dim else None)

    c1, v1, p1, e1, d1 = objects(n)
    c2, v2, p2, e2, d2 = objects(m)
    a = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    t = rng.uniform(-5.0, 5.0, 3)
    c2[:k] = (c1[:k] - t) @ R + rng.normal(scale=0.02, size=(k, 3))
    v2[:k], p2[:k], e2[:k] = v1[:k], p1[:k], e1[:k]
    if desc_dim:
        d2[:k] = d1[:k] + rng.normal(scale=0.1, size=(k, desc_dim))

    def segs(c, v, p, e, d, id0):
        return [SegmentData(id=id0 + i, center=c[i], volume=float(v[i]),
                            linearity=float(p[i, 0]), planarity=float(p[i, 1]),
                            scattering=float(p[i, 2]), extent=e[i],
                            semantic_descriptor=None if d is None else d[i])
                for i in range(len(c))]

    return segs(c1, v1, p1, e1, d1, 0), segs(c2, v2, p2, e2, d2, 10000)


def run_viz_clis(workdir, params_dir):
    """The viz CLIs on phase 3's tree, as processes started together.
    Where matplotlib (or cv2, for the videos) is absent, each must exit
    non-zero with an ImportError naming the package and write nothing;
    where it is present, each must write its files."""
    import importlib.util

    have = {p: importlib.util.find_spec(p) is not None for p in ("matplotlib", "cv2")}
    viz = os.path.join(workdir, "viz")
    pkl = os.path.join(workdir, "map", f"{ROBOTS[0]}.pkl")
    align_pkl = os.path.join(workdir, "align", "_".join(ROBOTS), "align.pkl")
    jobs = {
        "map_viz": ([pkl, "-o", os.path.join(viz, "map.png")],
                    "matplotlib", [os.path.join(viz, "map.png")]),
        "o3d_viz": ([pkl, "-o", os.path.join(viz, "o3d.png"), "--no-orig"],
                    "matplotlib", [os.path.join(viz, "o3d.png")]),
        "submap_viz": (["-p", params_dir, "-o", workdir, "-t"], "matplotlib",
                       [os.path.join(workdir, "submap_viz")]),
        "association_vid": ([align_pkl, "-o", os.path.join(viz, "assoc")],
                            "matplotlib", [os.path.join(viz, "assoc")]),
        "association_vid --camera-video": (
            [align_pkl, "-o", os.path.join(viz, "camera"), "--camera-video"], "cv2",
            [os.path.join(viz, "camera")]),
    }
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"roman_tpu_torch.demo.{name.split()[0]}", *argv],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (argv, _, _) in jobs.items()}
    t0 = time.perf_counter()
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        _, pkg, outputs = jobs[name]
        written = [p for p in outputs if os.path.exists(p)]
        if have[pkg]:
            require(proc.returncode == 0 and len(written) == len(outputs),
                    f"{name} failed where {pkg} is installed: {err[-2000:]}")
        else:
            last = err.strip().splitlines()[-1] if err.strip() else ""
            require(proc.returncode != 0 and last.startswith("ImportError")
                    and repr(pkg) in last and not written,
                    f"{name} without {pkg}: rc {proc.returncode}, wrote {written}, "
                    f"said {last!r}")
        print(f"viz CLI {name}: rc {proc.returncode}, {pkg} "
              f"{'installed' if have[pkg] else 'absent'}, wrote "
              f"{len(written)} of {len(outputs)}"
              + ("" if have[pkg] else f" ({last})"), flush=True)
    return time.perf_counter() - t0


def register_breakdown(reg, segs, reps=16):
    """Where a register call's time goes, on the first pair: packing the
    two object lists into features, register_clipper (the fused path's four
    launches and the transform's), the selection's copy to the host; and
    the card's busy time in a call from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch.align.registration import register_clipper

    s1, s2 = segs[0]
    parts = dict(pack=0.0, register_clipper=0.0, copy=0.0)
    for _ in range(reps):
        t0 = time.perf_counter()
        f1, f2 = reg._features(s1, s2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = register_clipper(f1, f2, reg.cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res.sel.cpu()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k] += v * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            reg.register(s1, s2)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    kernels = {k: sum(e.self_device_time_total for e in events if f"{k}_kernel" in e.name)
               / 1e3 / reps for k in ("assoc_terms", "build_affinity", "clipper_solve",
                                      "round_refine")}
    print(f"a register call ({len(s1)} x {len(s2)}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; profiled {wall:.3f} ms a call, the card busy {busy:.3f} ms in "
          f"{len(events) / reps:.0f} device events (kernels: "
          + ", ".join(f"{k} {v:.3f}" for k, v in kernels.items()) + " ms)", flush=True)


def run_per_pair(submaps, cfg, grid_pairs_per_s, workdir, demo, device):
    """The reference's per-pair classes and the loop_closures CLI on the
    card: the classes on the bench world's first PER_PAIR_PAIRS submap
    pairs at their unpadded sizes against their CPU runs, with every launch
    count set to 0 just before and read just after; the shape sweep and
    the largest shape the kernels take, against the CPU, and the shapes
    above the limits refused with ValueError before any launch; the
    loop_closures CLI on the first two robots of phase 10's demo run
    (`demo`, run_demo_sim's result) against that run's align stage, both
    at submap_align's default chunk; the viz CLIs on phase 3's tree.
    Returns the launches of the classes' and of the CLI's run."""
    import dataclasses

    import torch
    import yaml

    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper import ClipperSolveParams
    from roman_tpu_torch.align.object_registration import ObjectRegistration
    from roman_tpu_torch.demo import loop_closures

    cpu = torch.device("cpu")
    on_card, on_cpu = per_pair_classes(cfg, device), per_pair_classes(cfg, cpu)
    n1 = len(submaps[1])
    pairs = [(k // n1, k % n1) for k in range(PER_PAIR_PAIRS)]
    segs = [(submaps[0][i].segments, submaps[1][j].segments) for i, j in pairs]
    results, ms = {}, {}
    torch.cuda.synchronize()
    reset_launches()
    for name, reg in on_card.items():
        t0 = time.perf_counter()
        results[name] = [reg.register(s1, s2) for s1, s2 in segs]
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(segs)
    counts = read_launches()
    cpu_s = time.perf_counter()
    t_err = 0.0
    for name, reg in on_cpu.items():
        for (i, j), (s1, s2), A in zip(pairs, segs, results[name]):
            again, err = same_registration(on_card[name], reg, s1, s2,
                                           f"{name} on pair ({i}, {j})")
            t_err = max(t_err, err)
            require(np.array_equal(A, again),
                    f"{name} on pair ({i}, {j}) is not repeatable on the card")
    cpu_s = time.perf_counter() - cpu_s
    sizes = np.array([(len(a), len(b)) for a, b in segs])
    lcs = {k: sum(len(A) >= 4 for A in v) for k, v in results.items()}
    print(f"per-pair classes on the first {len(segs)} pairs (n {sizes[:, 0].min()}-"
          f"{sizes[:, 0].max()}, m {sizes[:, 1].min()}-{sizes[:, 1].max()}, unpadded): "
          "associations equal to the CPU's, the engine's T_align within "
          f"{t_err:.3g} of the CPU's (limit 1e-4); "
          + ", ".join(f"{k} {v:.3f} ms a register call ({lcs[k]} pairs with >= 4 "
                      "associations)" for k, v in ms.items())
          + f", against the grid's {1e3 / grid_pairs_per_s:.4f} ms a pair at chunk "
          f"{KERNEL_PAIRS}; launches {counts}; the CPU's runs {cpu_s:.1f} s; "
          f"{nvidia_smi()}", flush=True)
    require(all(v > 0 for v in counts.values()),
            f"a kernel was not launched by the per-pair classes: {counts}")
    register_breakdown(on_card["ROMANRegistration"], segs)

    # the shape sweep
    roman_card, roman_cpu = on_card["ROMANRegistration"], on_cpu["ROMANRegistration"]
    t0 = time.perf_counter()
    swept, t_err = [], 0.0
    for s, (n, m) in enumerate(SWEEP):
        for D in ((DESC_DIM, 0) if n * m < 10000 else (DESC_DIM,)):
            s1, s2 = sweep_pair(n, m, D, seed=100 + s)
            A, err = same_registration(roman_card, roman_cpu, s1, s2,
                                       f"sweep {n} x {m}, D {D}")
            t_err = max(t_err, err)
            swept.append(f"{n}x{m}/D{D}: {len(A) if A.size else 0}")
    print(f"shape sweep, card against CPU (associations found): {', '.join(swept)}; "
          f"the engine's T_align within {t_err:.3g} of the CPU's; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the largest square the kernels take, and the shapes above the limits
    small = dataclasses.replace(roman_card.cfg, solver=ClipperSolveParams(**LARGEST_SOLVER))
    k = fr.largest_side(small.solver.n_restarts, device)
    t0 = time.perf_counter()
    s1, s2 = sweep_pair(k, k, DESC_DIM, seed=200)
    big_card = ObjectRegistration(small, device=device)
    A = big_card.register(s1, s2)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    B = ObjectRegistration(small, device=cpu).register(s1, s2)
    cpu_big_s = time.perf_counter() - t0
    require(np.array_equal(A, B), f"{k} x {k}: associations differ from the CPU's")
    refused = {}
    reset_launches()
    for n, m in ((k + 1, k + 1), (1, fr.ROUND_MAX_SIDE + 1)):
        s1, s2 = sweep_pair(n, m, DESC_DIM, seed=201)
        try:
            big_card.register(s1, s2)
        except ValueError as e:
            refused[(n, m)] = str(e)
        require((n, m) in refused, f"{n} x {m} was not refused")
    require(not any(read_launches().values()), "a refused shape launched a kernel")
    print(f"largest square the kernels take: {k} x {k} (N = {k * k}) at 1 restart, "
          f"{len(A)} associations equal to the CPU's (solve budget {LARGEST_SOLVER}; "
          f"card {card_s:.2f} s, CPU {cpu_big_s:.2f} s); refused: "
          + "; ".join(f"{n} x {m}: {msg}" for (n, m), msg in refused.items()), flush=True)
    require("clipper_solve" in refused[(k + 1, k + 1)] and
            "round_refine" in refused[(1, fr.ROUND_MAX_SIDE + 1)],
            "a refusal does not name the kernel whose limit it is")

    # the loop_closures CLI on phase 10's first two robots, with the
    # demo's params, against the demo's align stage for that pair
    r0, r1 = demo["runs"][:2]
    out = os.path.join(workdir, "loop_closures")
    reset_launches()
    t0 = time.perf_counter()
    loop_closures.main([os.path.join(demo["out"], "map", f"{r}.pkl") for r in (r0, r1)]
                       + ["-o", out, "-p", os.path.join(demo["params"], "submap_align.yaml"),
                          "-g"] + [os.path.join(demo["out"], "gt", f"{r}.yaml")
                                   for r in (r0, r1)]
                       + (["--cpu"] if device.type == "cpu" else []))
    torch.cuda.synchronize()
    lc_s = time.perf_counter() - t0
    lc_counts = read_launches()

    def edges(path):
        with open(path) as f:
            return [ln for ln in f.read().splitlines() if ln.startswith("EDGE")]

    got = edges(os.path.join(out, "align.g2o"))
    ref = edges(os.path.join(demo["out"], "align", f"{r0}_{r1}", "align.g2o"))
    print(f"loop_closures CLI on {r0} and {r1} of phase 10: {len(got)} EDGE lines, "
          f"{lc_s:.2f} s, launches {lc_counts}", flush=True)
    require(got and got == ref,
            "the loop_closures CLI's EDGE lines differ from the demo's align stage")
    require(all(v > 0 for v in lc_counts.values()),
            f"a kernel was not launched by the loop_closures CLI: {lc_counts}")
    pdir = os.path.join(workdir, "per_pair_params")
    os.makedirs(pdir)
    with open(os.path.join(pdir, "submap_align.yaml"), "w") as f:
        yaml.safe_dump(MAIN_PATH_PARAMS, f)
    with open(os.path.join(pdir, "data.yaml"), "w") as f:
        yaml.safe_dump({"runs": ROBOTS}, f)
    run_viz_clis(workdir, pdir)
    return dict(launches=counts, cli_launches=lc_counts, ms=ms, largest=k)

# ---------------------------------------------------------------------------
# phase 15: the pair grid over a mesh, dryrun_multichip, the native referee
# ---------------------------------------------------------------------------

NATIVE_PAIRS = 8
RESULT_FIELDS = ("sel", "count", "T_align", "ok", "score", "converged")


def run_mesh(feats, auxs, cfg, grid):
    """Phase 15: the 506-pair grid split over get_mesh() (the visible
    cards, at 32 pairs a card) and over four virtual shards on cuda:0 at
    chunks 128 and 32, each against phase 4's unsharded grid at chunk 32;
    dryrun_multichip on one card and on four virtual shards, with every
    launch count set to 0 just before and read just after; the port's
    native referee on the first NATIVE_PAIRS bench pairs."""
    import torch

    from roman_tpu_torch import native
    from roman_tpu_torch.align.submap_align import PairGridRegistrar
    from roman_tpu_torch.parallel.mesh import get_mesh
    from roman_tpu_torch.parallel.multichip import dryrun_multichip

    mesh = get_mesh()
    print(f"mesh: torch.cuda.device_count() {torch.cuda.device_count()}, "
          f"get_mesh() {mesh}", flush=True)
    pair_i, pair_j = full_grid(feats)
    P = len(pair_i)
    ids = [a["seg_ids"] for a in auxs]
    ref = grid["result"]
    virtual = get_mesh(4, device="cuda:0")
    # chunk 128 over four shards gives each launch the 32 pairs (and so the
    # clipper_solve cluster size) of the unsharded chunk 32: bytes equal;
    # chunk 32 gives launches of 8 pairs, another cluster size
    layouts = ((f"get_mesh() ({mesh.size} card(s)), chunk {KERNEL_PAIRS * mesh.size}",
                mesh, KERNEL_PAIRS * mesh.size, True),
               ("4 virtual shards on cuda:0, chunk 128", virtual, 128, True),
               (f"4 virtual shards on cuda:0, chunk {KERNEL_PAIRS}", virtual,
                KERNEL_PAIRS, False))
    rates = {}
    for name, m, chunk, exact in layouts:
        reg = PairGridRegistrar(cfg, chunk_size=chunk, mesh=m)
        res = reg(feats[0], feats[1], ids[0], ids[1], pair_i, pair_j)  # warmup
        best = np.inf
        for _ in range(3):
            reset_launches()
            t0 = time.perf_counter()
            res = reg(feats[0], feats[1], ids[0], ids[1], pair_i, pair_j)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        counts = read_launches()
        rates[name] = P / best
        same = {f: bool(np.array_equal(getattr(res, f), getattr(ref, f)))
                for f in RESULT_FIELDS}
        T_err = float(np.max(np.abs(res.T_align - ref.T_align)))
        lc = lambda r: r.ok & (r.count >= 4)  # noqa: E731
        lc_agree = float(np.mean(lc(res) == lc(ref)))
        print(f"mesh grid, {name}: {P / best:.1f} pairs/s (shards share the card "
              f"when virtual; a record), launches {counts}, rescued {reg.rescued}; "
              f"equal to phase 4's chunk {KERNEL_PAIRS}: {same}, T_align within "
              f"{T_err:.3e}, LC agreement {lc_agree}", flush=True)
        if exact:
            require(all(same.values()), f"{name}: not byte-equal to the unsharded grid")
        else:
            require(same["sel"] and same["count"] and T_err <= 1e-4 and lc_agree == 1.0,
                    f"{name}: differs from the unsharded grid")
        require(all(v > 0 for v in counts.values()), f"{name}: a kernel was not launched")

    t0 = time.perf_counter()
    reset_launches()
    dry = [dryrun_multichip(1), dryrun_multichip(4, device="cuda:0")]
    torch.cuda.synchronize()
    counts = read_launches()
    print(f"dryrun_multichip(1) and (4, cuda:0): {time.perf_counter() - t0:.1f} s, "
          f"launches {counts}; grid bytes equal to unsharded "
          f"{[d['grid']['same_bytes'] for d in dry]}, GN step within "
          f"{[d['pgo']['max_abs_err'] for d in dry]}", flush=True)
    require(all(v > 0 for v in counts.values()),
            f"a kernel was not launched by dryrun_multichip: {counts}")

    t0 = time.perf_counter()
    native.get_lib()
    built = time.perf_counter() - t0
    args = []
    for i, j in zip(pair_i[:NATIVE_PAIRS], pair_j[:NATIVE_PAIRS]):
        sides = []
        for f, k in ((feats[0], i), (feats[1], j)):
            v = f.valid[k].cpu().numpy()
            sides.append([x[k].cpu().numpy()[v] for x in
                          (f.centers, f.ratio_feats, f.descriptors)])
        args.append(sides[0] + sides[1])
    knobs = (cfg.sigma, cfg.epsilon, cfg.mindist, cfg.cos_min, cfg.cos_max)
    t0 = time.perf_counter()
    sels = [native.clipper_ref_solve_native(*a, *knobs) for a in args]
    serial = NATIVE_PAIRS / (time.perf_counter() - t0)
    lc_ref = np.array([len(s) >= 4 for s in sels])
    lc_eng = ref.ok[:NATIVE_PAIRS] & (ref.count[:NATIVE_PAIRS] >= 4)
    print(f"native referee: built with g++ {' '.join(native.CXX_FLAGS)} in {built:.1f} s "
          f"({os.path.relpath(native.library_path())}); serial C++ CLIPPER "
          f"{serial:.3f} pairs/s on the first {NATIVE_PAIRS} bench pairs (the grid: "
          f"{grid['pairs_per_s']:.1f}); associations {[len(s) for s in sels]}, LC "
          f"agreement with the kernels {float(np.mean(lc_ref == lc_eng))} (a record)",
          flush=True)
    return dict(rates=rates, launches=counts, native_pairs_per_s=serial)

# ---------------------------------------------------------------------------
# phase 16: the adversarial quality sweep (roman_tpu_torch.eval.adversarial)
# ---------------------------------------------------------------------------

# adversarial_eval.py's defaults: 24 positives and 16 negatives a scenario,
# one seed, capacity 40, 128-d descriptors, one restart, the referee on
ADV_PAIRS = 24
ADV_CAPACITY = 40
ADV_DESC_DIM = 128


def run_adversarial(device):
    """Phase 16: the eight nuisance scenarios through the kernels and
    through the serial numpy referee, every launch count set to 0 just
    before and read just after (all five kernels must launch); then the
    same pairs through the plain twins on the card, whose LC decisions
    must equal the kernels' on every pair."""
    import torch

    from roman_tpu_torch.eval import adversarial as adv

    cfg = adv.make_config(1)
    sweep = dict(pairs=ADV_PAIRS, capacity=ADV_CAPACITY, desc_dim=ADV_DESC_DIM)
    t0 = time.perf_counter()
    reset_launches()
    results = list(adv.sweep(cfg, device, referee=True, **sweep))
    torch.cuda.synchronize()
    counts = read_launches()
    wall = time.perf_counter() - t0
    with plain_path():
        plain = [d for _, d in adv.sweep(cfg, device, referee=False, **sweep)]
    agree_all = []
    for (row, d), p in zip(results, plain):
        e, b = d["engine"], d["referee"]
        outcome = lambda x: np.stack([x["predicted"], x["predicted"] & x["good"]], 1)  # noqa: E731
        vs_referee = float(np.mean((outcome(e) == outcome(b)).all(1)))
        vs_plain = float(np.mean(e["predicted"] == p["engine"]["predicted"]))
        same_counts = bool(np.array_equal(e["counts"], p["engine"]["counts"]))
        agree_all.append(vs_plain)
        pr = lambda who: (  # noqa: E731
            f"P {row[who + '_precision']} [{row[who + '_p_ci'][0]:.3f}, "
            f"{row[who + '_p_ci'][1]:.3f}] R {row[who + '_recall']} "
            f"[{row[who + '_r_ci'][0]:.3f}, {row[who + '_r_ci'][1]:.3f}]")
        print(f"adversarial {row['scenario']}: {row['pairs']} pairs; engine "
              f"{pr('engine')}, referee {pr('referee')}; outcome agreement engine vs "
              f"referee {vs_referee}; LC decisions vs the plain twins on the card "
              f"{vs_plain} (counts equal {same_counts}); engine "
              f"{d['seconds']['engine']:.2f} s, referee {d['seconds']['referee']:.2f} s",
              flush=True)
    print(f"adversarial sweep (capacity {ADV_CAPACITY}, {ADV_DESC_DIM}-d, "
          f"{ADV_PAIRS} positives + {max(ADV_PAIRS * 2 // 3, 4)} negatives a scenario): "
          f"wall {wall:.1f} s, launches {counts}; {nvidia_smi()}", flush=True)
    require(all(v > 0 for v in counts.values()),
            f"a kernel was not launched by the adversarial sweep: {counts}")
    require(all(a == 1.0 for a in agree_all),
            f"the kernels' LC decisions differ from the plain twins': {agree_all}")
    return dict(launches=counts, wall=wall, rows=[r for r, _ in results])

# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 1
    from roman_tpu_torch.kernels import build

    t_script = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    log = build.build_all()
    print(f"built {len(list(build.SRC_DIR.glob('*.cu')))} sources with "
          f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas = ptxas_summary(log)
    for line in ptxas:
        print("  " + line, flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runs, maps = make_world()
    submaps, feats, auxs, cfg = grid_features(maps, dev)
    print(f"bench world: {len(submaps[0])} x {len(submaps[1])} submaps, "
          f"capacity {CAPACITY}, {DESC_DIM}-d, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    records = check_kernels(feats, auxs, cfg, ptxas)
    with tempfile.TemporaryDirectory() as main_dir, \
            tempfile.TemporaryDirectory() as demo_dir:
        main_counts, _, _ = run_main_path(runs, maps, main_dir, dev)
        require(all(v > 0 for v in main_counts.values()),
                f"a kernel was not launched on the main path: {main_counts}")
        grid = run_grid(feats, auxs, runs, cfg)
        run_arithmetic_mean(feats, auxs, cfg)
        run_prune_grid(feats, auxs, runs, cfg)
        run_ransac_grid(feats, auxs, runs, cfg)
        run_back_half(runs, main_dir, dev)
        run_mapping_bench(dev)
        demo_sim = run_demo_sim(dev, demo_dir)  # kept for phase 14
        run_perception_bench(dev)
        with tempfile.TemporaryDirectory() as workdir:
            run_rgbd_mapping(dev, workdir)
        with tempfile.TemporaryDirectory() as workdir:
            demo_bag = run_demo_bag(dev, workdir)
        t0 = time.perf_counter()
        per_pair = run_per_pair(submaps, cfg, grid["pairs_per_s"], main_dir, demo_sim, dev)
        print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mesh = run_mesh(feats, auxs, cfg, grid)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    adversarial = run_adversarial(dev)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)

    sources = {"clipper_solve": "roman_tpu_torch/csrc/clipper_solve.cu",
               "arun_align": "roman_tpu_torch/csrc/arun_align.cu"}
    replaces = {"clipper_solve": "roman_tpu/align/clipper_pallas.py:50",
                "arun_align": "roman_tpu/ops/arun.py:54"}
    line = {"kernels": [dict(
        name=r["name"], route="cuda",
        source=sources.get(r["name"], "roman_tpu_torch/csrc/fused_register.cu"),
        replaces=replaces.get(r["name"], "roman_tpu/align/fused_register.py:111"),
        launches=main_counts[r["name"]], demo_launches=demo_sim["launches"][r["name"]],
        bag_demo_launches=demo_bag["launches"][r["name"]],
        per_pair_launches=per_pair["launches"][r["name"]],
        loop_closures_launches=per_pair["cli_launches"][r["name"]],
        mesh_launches=mesh["launches"][r["name"]],
        adversarial_launches=adversarial["launches"][r["name"]],
        max_abs_err=r["max_abs_err"],
        ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0],
        bound_by=r["bound"][1], library_ms=None) for r in records]}
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
