#!/usr/bin/env python3
"""Time the port's kernels and the pair grid on one CUDA card.

Run from the root of a checkout of the port (the checkout's own
``chip_smoke.py`` and ``roman_tpu_torch`` are imported from the working
directory, so the same script times an older checkout too):

    python3 scripts/time_solve.py [label]

On the bench world of ``chip_smoke.py`` (seed 0, capacity 40, N = 1600)
it prints one JSON line: the card and its power limit; ``assoc_terms``
and ``build_affinity`` in ms on 32 and 3 pairs and on 32 pairs at
capacity 64 (N = 4096), with sha256 digests of their outputs on the
32-pair chunk (hl, nz, single, vflat; and M built from the plain twin's
terms), so two checkouts can be compared bit for bit; ``round_refine`` in
ms on the plain solve's outputs on 32 pairs, on 3 pairs at the rescue
budget (the rescue launch) and on 32 pairs at capacity 64, with the
sha256 of its (sel, count) on the 32-pair chunk; ``clipper_solve``
in ms, with the live rows of each chunk's M (rows holding a nonzero: mean
and most a pair, and their share of all rows), on 32 pairs at the default
budget, on 1 and 8 pairs, on 8 pairs at the rescue budget, on 32 pairs of
a dense M (uniform bf16 in (0, 1) from a fixed seed: every row live), on
the first 64 pairs of the benchmark's grid (``benchmark/world.py``'s
scene, its configuration's statics) and on the first 64 pairs of its
no-GPU grid (``roman-demo-nogpu-align``: no descriptors, so nearly every
row of M live though 96% of its entries are zeros) at the main and the
rescue budget, each of these two beside its bound (M's bytes read once,
or its bf16 matvecs at the card's peak), with the sha256 of its (u, d,
F, omega) on the 32-pair chunk, on the 64 grid pairs and on the 64
no-GPU pairs at both budgets; and
PairGridRegistrar pairs/s over the 506-pair grid (best of 3) at chunks
32, 64 and 128. Kernel times are device times from torch.profiler, means
of 10 launches after a warmup.

To compare two checkouts, run them in one call in turns A B B A, e.g.
``for d in old . . old; do (cd $d && python3 $OLDPWD/scripts/time_solve.py $d); done``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time in ms of the kernels whose name holds `kernel`, per
    call of fn() (one warmup call, then reps calls under torch.profiler):
    without the host's launch gaps, which CUDA events around a launch of a
    few tens of microseconds would count. Defined here, and imported by
    chip_smoke.py, so that this script also times checkouts whose
    chip_smoke.py lacks it. Raises when the profiler saw no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key)
    if total <= 0:
        raise RuntimeError(f"the profiler saw no kernel named like {kernel!r}")
    return total / reps / 1e3


def grid_chunk(dev, P: int, config: str = "roman-demo-align"):
    """(M, valid, capacity) of the first P pairs of the benchmark's grid
    under a configuration (for the no-GPU one, roman-demo-nogpu-align, the
    descriptors cut to width 0 as its entry cuts them), built by the fused
    path's first two kernels. The statics are spelled out as
    registration.solve_clipper builds them, so that older checkouts run
    this too."""
    import dataclasses
    import json

    import torch

    from benchmark import world
    from benchmark.entries import align_common
    from roman_tpu_torch.align import fused_register as fr

    with open(os.path.join("benchmark", "configs", f"{config}.json")) as f:
        config = json.load(f)
    subs = world.make_scene(config)
    if config["semantics_dim"] == 0:
        subs = [dataclasses.replace(s, desc=s.desc[..., :0]) for s in subs]
    pi, pj = (g[:P] for g in world.full_grid(subs))
    f1, f2 = (align_common.features(s, dev).map(lambda x, k=k: x[torch.as_tensor(k, device=dev)])
              for s, k in zip(subs, (pi, pj)))
    cfg = align_common.registration_config(config)
    gravity, use_ratio, use_cosine = cfg.solve_flags
    inv = fr.FusedInvariantStatics(
        sigma=cfg.sigma, epsilon=cfg.epsilon, mindist=cfg.mindist,
        cos_min=cfg.cos_min, cos_max=cfg.cos_max, eps_shape=cfg.epsilon_shape,
        gravity=gravity, gravity_unc_ang_rad=cfg.gravity_unc_ang_rad,
        use_ratio=use_ratio and f1.ratio_feats.shape[-1] > 0,
        use_cosine=use_cosine and f1.descriptors.shape[-1] > 0,
        max_clique=cfg.max_clique)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    fl = [x.float().contiguous() for x in (f1.ratio_feats, f1.descriptors,
                                            f2.ratio_feats, f2.descriptors)]
    hl, nz, single, vflat = fr.assoc_terms(*fl, valid, inv)
    M = fr.build_affinity(f1.centers.float().contiguous(), f2.centers.float().contiguous(),
                          hl, nz, single, vflat, inv)
    return M, vflat, f1.capacity


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper import ClipperSolveParams
    from roman_tpu_torch.align.clipper_solve import (clipper_solve,
                                                     clipper_solve_plain)
    from roman_tpu_torch.align.registration import RESCUE_SOLVER
    from roman_tpu_torch.align.submap_align import PairGridRegistrar
    from roman_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("time_solve.py needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    dev = torch.device("cuda")
    runs, maps = cs.make_world()
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": cs.nvidia_smi()}

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    for capacity in (cs.CAPACITY, 64):
        _, feats_c, auxs_c, cfg_c = cs.grid_features(maps, dev, capacity=capacity)
        pi, pj = cs.kernel_pairs(auxs_c)
        f1 = feats_c[0].map(lambda x: x[torch.as_tensor(pi, device=dev)].contiguous())
        f2 = feats_c[1].map(lambda x: x[torch.as_tensor(pj, device=dev)].contiguous())
        inv = fr.FusedInvariantStatics(cos_min=cfg_c.cos_min, cos_max=cfg_c.cos_max,
                                       max_clique=cfg_c.max_clique)
        valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
        a_args = (f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors,
                  valid, inv)
        hl, nz, single, vflat = fr.assoc_terms_plain(*a_args)
        b_args = (f1.centers, f2.centers, hl, nz, single, vflat, inv)
        for P in ((32, 3) if capacity == cs.CAPACITY else (32,)):
            ap = tuple(x[:P].contiguous() for x in a_args[:5]) + (inv,)
            bp = tuple(x[:P].contiguous() for x in b_args[:6]) + (inv,)
            key = f"p{P}" + ("" if capacity == cs.CAPACITY else f"_cap{capacity}")
            out[f"assoc_terms_{key}_ms"] = device_ms(
                lambda: fr.assoc_terms(*ap), 10, "assoc_terms_kernel")
            out[f"build_affinity_{key}_ms"] = device_ms(
                lambda: fr.build_affinity(*bp), 10, "build_affinity_kernel")
        if capacity == cs.CAPACITY:
            out["sha256_assoc_terms_p32"] = digest(*fr.assoc_terms(*a_args))
            out["sha256_build_affinity_p32"] = digest(fr.build_affinity(*b_args))
            feats, auxs, cfg = feats_c, auxs_c, cfg_c
            M, v_main = fr.build_affinity_plain(*b_args), vflat
            Mr, shapes = M, ((32, ClipperSolveParams()), (3, RESCUE_SOLVER))
        else:
            Mr, shapes = fr.build_affinity(*b_args), ((32, ClipperSolveParams()),)
        # round_refine on the plain solve's outputs: the main path's chunk, the
        # rescue launch's 3 pairs at the rescue budget, and capacity 64
        for P, params in shapes:
            Mp, vp = Mr[:P].contiguous(), vflat[:P].contiguous()
            u, _, F, om = clipper_solve_plain(Mp, vp, capacity, capacity, params)
            r_args = (Mp, u, F, om, capacity, capacity, inv)
            key = f"p{P}" + ("" if capacity == cs.CAPACITY else f"_cap{capacity}")
            out[f"round_refine_{key}_ms"] = device_ms(
                lambda: fr.round_refine(*r_args), 10, "round_refine_kernel")
            if key == "p32":
                out["sha256_round_refine_p32"] = digest(*fr.round_refine(*r_args))
        del f1, f2, a_args, b_args, ap, bp, Mr, Mp, r_args
    gen = torch.Generator(device=dev).manual_seed(0)
    dense = torch.rand(M[:32].shape, generator=gen, device=dev).to(torch.bfloat16)
    grid_M, grid_v, grid_cap = grid_chunk(dev, 64)
    nosem_M, nosem_v, nosem_cap = grid_chunk(dev, 64, "roman-demo-nogpu-align")
    for name, Mp, vp, cap, params in (
            ("p32", M[:32], v_main[:32], cs.CAPACITY, ClipperSolveParams()),
            ("p1", M[:1], v_main[:1], cs.CAPACITY, ClipperSolveParams()),
            ("p8", M[:8], v_main[:8], cs.CAPACITY, ClipperSolveParams()),
            ("rescue_p8", M[:8], v_main[:8], cs.CAPACITY, RESCUE_SOLVER),
            ("dense_p32", dense, v_main[:32], cs.CAPACITY, ClipperSolveParams()),
            ("grid_p64", grid_M, grid_v, grid_cap, ClipperSolveParams()),
            ("nosem_p64", nosem_M, nosem_v, nosem_cap, ClipperSolveParams()),
            ("rescue_nosem_p64", nosem_M, nosem_v, nosem_cap, RESCUE_SOLVER)):
        Mp, vp = Mp.contiguous(), vp.contiguous()
        ms = device_ms(lambda: clipper_solve(Mp, vp, cap, cap, params), 10,
                       "clipper_solve_kernel")
        live = (Mp != 0).any(dim=-1).sum(dim=-1)  # rows holding a nonzero, a pair
        out[name] = {"ms": ms, "live_rows_mean": live.double().mean().item(),
                     "live_rows_max": int(live.max()),
                     "live_share": live.sum().item() / Mp.shape[0] / Mp.shape[1]}
        if name.endswith("nosem_p64"):
            matvecs = params.warmup_iters + params.outer_iters * (params.inner_iters + 1) + 1
            N = Mp.shape[1]
            out[name]["bound_ms"], out[name]["bound_by"] = cs.bound(
                cs.nbytes(Mp), bf16_ops=2.0 * N * N * matvecs * Mp.shape[0])
            out[name]["nonzero_share"] = (Mp != 0).sum().item() / Mp.numel()
        if name in ("p32", "grid_p64", "nosem_p64", "rescue_nosem_p64"):
            out[f"sha256_clipper_solve_{name}"] = digest(
                *clipper_solve(Mp, vp, cap, cap, params))
    del M, dense, grid_M, nosem_M

    ids = [a["seg_ids"] for a in auxs]
    gi, gj = cs.full_grid(feats)

    def register(chunk):
        reg = PairGridRegistrar(cfg, chunk_size=chunk, device=dev)
        return reg(feats[0], feats[1], ids[0], ids[1], gi, gj)

    register(cs.KERNEL_PAIRS)
    torch.cuda.synchronize()
    for chunk in (cs.KERNEL_PAIRS, 64, 128):
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            register(chunk)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out[f"pairs_per_s_chunk{chunk}"] = len(gi) / best
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
