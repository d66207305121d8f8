"""Traffic entry `pair_grid`: each operation is one call of the port's
`PairGridRegistrar` over every pair of the scene's submap grid, in an
order drawn from the run's seed, with the results on the host.

The scene's features are packed on the device in set-up; the registrar
is built once. Every call registers the same pairs, so the reference
registers them once and every call's answers are held against it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import world
from benchmark.entries import align_common as common


class Cell:
    unit = "pairs"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from roman_tpu_torch.align.submap_align import PairGridRegistrar

        self.config, self.device = config, device
        self.subs = world.make_scene(config)
        pi, pj = world.full_grid(self.subs)
        order = np.random.default_rng(seed).permutation(len(pi))
        self.pair_i, self.pair_j = pi[order], pj[order]
        self.feats = [common.features(s, device) for s in self.subs]
        self.registrar = PairGridRegistrar(common.registration_config(config),
                                           chunk_size=traffic["chunk_size"],
                                           device=device)
        self.seed = seed
        self.rescued = 0
        self.live = None  # each pair's live affinity entries, from the reference
        for _ in range(traffic["warmup_ops"]):
            self.op(0)

    def op(self, k: int):
        """One grid call; returns (its answers, pairs registered)."""
        res = self.registrar(self.feats[0], self.feats[1], self.subs[0].ids,
                             self.subs[1].ids, self.pair_i, self.pair_j, seed=self.seed)
        self.rescued = self.registrar.rescued
        return (res.sel, res.count, res.T_align), len(self.pair_i)

    def describe(self) -> str:
        return (f"{len(self.pair_i)} pairs a call from a {len(self.subs[0].valid)} x "
                f"{len(self.subs[1].valid)} grid, {self.rescued} re-solved at the rescue budget")

    def work(self, n_ops: int):
        """The registration's work in n_ops calls (metrics/_counts.py),
        once the reference has counted the live entries."""
        from benchmark.metrics import _counts

        if self.live is None:
            return None
        n = self.subs[0].sizes[self.pair_i]
        m = self.subs[1].sizes[self.pair_j]
        w = _counts.registration_work(
            n, m, desc_dim=self.subs[0].desc.shape[-1],
            n_ratio=self.subs[0].ratio.shape[-1], live=self.live,
            sides=[s.sizes for s in self.subs], rescued=self.rescued,
            capacity=self.subs[0].valid.shape[1])
        return {k: v * n_ops for k, v in w.items()}

    def release(self):
        del self.registrar, self.feats
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw) -> dict:
        ref = common.reference(self.config, self.subs, self.pair_i, self.pair_j,
                               self.device, rescue=True, **kw)
        self.live = ref["live"]
        return ref

    def check(self, outputs: list) -> dict:
        """The comparison's numbers, worst over every call's answers."""
        from benchmark.reference import compare

        ref = self.reference()
        return compare.worst([compare.compare(*out, ref)
                              for out in outputs])

    def control(self) -> dict:
        """The numbers of the control: the reference in the program's
        place, at the configuration's narrower precisions."""
        from benchmark.reference import compare

        ref = self.reference()
        low = common.reference(self.config, self.subs, self.pair_i, self.pair_j,
                               self.device, rescue=True, **common.CONTROL)
        return compare.compare(low["sel"], low["count"], low["T"], ref)
