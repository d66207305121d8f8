"""Traffic entry `register`: each operation is one call of the port's
per-pair surface, `ROMANRegistration.register(segments_i, segments_j)`,
on one unpadded pair of the scene's submaps; the call returns numpy, so
it has waited for the card.

Pairs are taken in an order drawn from the seed that cycles the whole
grid; set-up warms up on one whole cycle when the traffic says
"cycle". The registration object and every submap's object list are made
in set-up; packing a pair's lists into tensors is part of each call, as
it is for a user of the class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import world
from benchmark.entries import align_common as common


@dataclasses.dataclass
class _Object:
    """An object as the per-pair surface reads it."""

    center: np.ndarray
    volume: float
    linearity: float
    planarity: float
    scattering: float
    semantic_descriptor: np.ndarray
    extent: np.ndarray = None


def _objects(subs, s: int) -> list:
    n = int(subs.sizes[s])
    return [_Object(center=subs.centers[s, q].astype(np.float64),
                    linearity=float(subs.ratio[s, q, 0]), planarity=float(subs.ratio[s, q, 1]),
                    scattering=float(subs.ratio[s, q, 2]), volume=float(subs.ratio[s, q, 3]),
                    semantic_descriptor=subs.desc[s, q].astype(np.float64))
            for q in range(n)]


def roman_params(config: dict):
    """The port's ROMANParams for the roman method of a configuration
    file (gravity, volume, pca and semantics on)."""
    from roman_tpu_torch.align.roman_registration import FusionMethod, ROMANParams

    if config["method"] != "roman":
        raise ValueError(f"the register entry takes the roman method, not {config['method']}")
    d = config["defaults"]
    return ROMANParams(point_dim=config["dim"],
                       fusion_method=FusionMethod(config["fusion_method"]),
                       sigma=d["sigma"], epsilon=d["epsilon"], mindist=d["mindist"],
                       gravity=True, volume=True, pca=True, extent=False,
                       semantics_dim=config["semantics_dim"],
                       gravity_unc_ang_rad=d["gravity_unc_ang_rad"],
                       cos_min=config["cosine_min"], cos_max=config["cosine_max"],
                       epsilon_shape=d["epsilon_shape"])


class Cell:
    unit = "calls"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from roman_tpu_torch.align.roman_registration import ROMANRegistration

        self.config, self.device = config, device
        self.subs = world.make_scene(config)
        pi, pj = world.full_grid(self.subs)
        order = np.random.default_rng(seed).permutation(len(pi))
        self.pair_i, self.pair_j = pi[order], pj[order]
        self.objects = [[_objects(s, k) for k in range(len(s.valid))] for s in self.subs]
        self.reg = ROMANRegistration(roman_params(config), device=device)
        warm = traffic["warmup_ops"]
        for k in range(len(self.pair_i) if warm == "cycle" else warm):
            self.op(k)

    def pair(self, k: int):
        q = k % len(self.pair_i)
        return int(self.pair_i[q]), int(self.pair_j[q])

    def op(self, k: int):
        """One register call on the k-th pair of the cycle; returns
        ((pair index, associations), 1)."""
        i, j = self.pair(k)
        return (k % len(self.pair_i), self.reg.register(self.objects[0][i],
                                                        self.objects[1][j])), 1

    def describe(self) -> str:
        n = self.subs[0].sizes[self.pair_i] * self.subs[1].sizes[self.pair_j]
        return (f"a cycle of {len(self.pair_i)} pairs, N = n * m median {np.median(n):.0f}, "
                f"{np.mean(n == n.max()):.3f} of them at N = {n.max()}")

    def release(self):
        del self.reg
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _selections(self, outputs) -> tuple:
        """Each output's (n, m) selection at the capacity's padding, and
        the pair indices of the cycle."""
        cap = self.subs[0].valid.shape[1]
        q = np.array([o[0] for o in outputs])
        sel = np.zeros((len(outputs), cap, cap), bool)
        for k, (_, assoc) in enumerate(outputs):
            assoc = np.asarray(assoc).reshape(-1, 2).astype(int)
            sel[k, assoc[:, 0], assoc[:, 1]] = True
        return q, sel

    def reference(self, **kw) -> dict:
        return common.reference(self.config, self.subs, self.pair_i, self.pair_j,
                                self.device, rescue=False, unpadded=True, **kw)

    def check(self, outputs: list) -> dict:
        """The comparison's numbers over every call's associations."""
        from benchmark.reference import compare

        ref = self.reference()
        q, sel = self._selections(outputs)
        nums = compare.compare(sel, ref["count"][q], ref["T"][q],
                               {k: v[q] for k, v in ref.items()})
        del nums["T_gap"]  # a call returns no transform
        return nums

    def control(self) -> dict:
        from benchmark.reference import compare

        ref = self.reference()
        low = self.reference(**common.CONTROL)
        nums = compare.compare(low["sel"], low["count"], low["T"], ref)
        del nums["T_gap"]
        return nums
