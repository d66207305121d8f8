"""Traffic entry `pair_grid_nosem`: the `pair_grid` entry for a deployment
whose maps carry no semantic descriptors (`roman_no_semantics`): each
operation is one call of the port's `PairGridRegistrar` over every pair of
the scene's submap grid, in an order drawn from the run's seed.

The scene is the configuration's, as `pair_grid` makes it; its descriptor
block is cut to width 0 before it is packed, so the program and the
reference see shapes alone. The answers are held against
`reference/clipper_f64_nosem.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.entries import align_common as common
from benchmark.entries import pair_grid
from benchmark.reference import clipper_f64, clipper_f64_nosem


def reference(config: dict, subs, pair_i, pair_j, device, rescue: bool, **kw) -> dict:
    """The reference's answers (numpy) to pairs (pair_i[p], pair_j[p]) of
    the two robots' submaps, in batches of common.REFERENCE_BATCH pairs.
    kw: clipper_f64_nosem.register's dtype and m_dtype."""
    p = clipper_f64.Params.from_config(config)
    out = {k: [] for k in ("sel", "count", "T", "F", "rescued", "live")}
    for s in range(0, len(pair_i), common.REFERENCE_BATCH):
        a, b = pair_i[s:s + common.REFERENCE_BATCH], pair_j[s:s + common.REFERENCE_BATCH]
        sides = [[torch.as_tensor(x[k], device=device) for x in (sub.centers, sub.ratio, sub.valid)]
                 for sub, k in zip(subs, (a, b))]
        res = clipper_f64_nosem.register(*sides[0], *sides[1], p, rescue=rescue, **kw)
        for k in out:
            out[k].append(res[k].double().cpu().numpy() if res[k].is_floating_point()
                          else res[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


class Cell(pair_grid.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, dict(traffic, warmup_ops=0), seed, device)
        self.subs = [dataclasses.replace(s, desc=s.desc[..., :0]) for s in self.subs]
        self.feats = [common.features(s, device) for s in self.subs]
        for _ in range(traffic["warmup_ops"]):
            self.op(0)

    def reference(self, **kw) -> dict:
        ref = reference(self.config, self.subs, self.pair_i, self.pair_j, self.device,
                        rescue=True, **kw)
        self.live = ref["live"]
        return ref

    def control(self) -> dict:
        from benchmark.reference import compare

        ref = self.reference()
        low = reference(self.config, self.subs, self.pair_i, self.pair_j, self.device,
                        rescue=True, **common.CONTROL)
        return compare.compare(low["sel"], low["count"], low["T"], ref)
