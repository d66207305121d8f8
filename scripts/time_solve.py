#!/usr/bin/env python3
"""Time the port's CLIPPER solve kernel and the pair grid on one CUDA card.

Run from the root of a checkout of the port (the checkout's own
``chip_smoke.py`` and ``roman_tpu_torch`` are imported from the working
directory, so the same script times an older checkout too):

    python3 scripts/time_solve.py [label]

On the bench world of ``chip_smoke.py`` (seed 0, capacity 40, N = 1600)
it prints one JSON line: the card and its power limit; ``clipper_solve``
in ms (CUDA events, mean of 10 after a warmup) and GB/s of M streamed
(matvecs x bytes of M / time) on 32 pairs at the default budget, on 1
and 8 pairs, and on 8 pairs at the rescue budget; and PairGridRegistrar
pairs/s over the 506-pair grid (best of 3) at chunks 32, 64 and 128.

To compare two checkouts, run them in one call in turns A B B A, e.g.
``for d in old . . old; do (cd $d && python3 $OLDPWD/scripts/time_solve.py $d); done``.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from roman_tpu_torch.align import fused_register as fr
    from roman_tpu_torch.align.clipper import ClipperSolveParams
    from roman_tpu_torch.align.clipper_solve import clipper_solve
    from roman_tpu_torch.align.registration import RESCUE_SOLVER
    from roman_tpu_torch.align.submap_align import PairGridRegistrar
    from roman_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("time_solve.py needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    dev = torch.device("cuda")
    runs, maps = cs.make_world()
    _, feats, auxs, cfg = cs.grid_features(maps, dev)
    pi, pj = cs.kernel_pairs(auxs)
    f1 = feats[0].map(lambda x: x[torch.as_tensor(pi, device=dev)].contiguous())
    f2 = feats[1].map(lambda x: x[torch.as_tensor(pj, device=dev)].contiguous())
    inv = fr.FusedInvariantStatics(cos_min=cfg.cos_min, cos_max=cfg.cos_max,
                                   max_clique=cfg.max_clique)
    valid = (f1.valid[:, :, None] & f2.valid[:, None, :]).float().contiguous()
    hl, nz, single, vflat = fr.assoc_terms_plain(
        f1.ratio_feats, f1.descriptors, f2.ratio_feats, f2.descriptors, valid, inv)
    M = fr.build_affinity_plain(f1.centers, f2.centers, hl, nz, single, vflat, inv)
    n = m = cs.CAPACITY
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": cs.nvidia_smi()}
    for name, P, params in (("p32", 32, ClipperSolveParams()),
                            ("p1", 1, ClipperSolveParams()),
                            ("p8", 8, ClipperSolveParams()),
                            ("rescue_p8", 8, RESCUE_SOLVER)):
        Mp, vp = M[:P].contiguous(), vflat[:P].contiguous()
        ms = cs.cuda_ms(lambda: clipper_solve(Mp, vp, n, m, params), 10)
        passes = params.warmup_iters + params.outer_iters * (params.inner_iters + 1) + 1
        out[name] = {"ms": ms, "GB/s": passes * Mp.numel() * 2 / ms / 1e6}
    del M

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
