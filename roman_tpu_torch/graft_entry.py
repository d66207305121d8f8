"""The port's counterpart of __graft_entry__.py: one module that answers
to the JAX package's entry points there.

- ``entry(device=None)``: the flagship compute, the batched ROMAN-invariant
  CLIPPER registration of a chunk of submap pairs (``register_clipper`` on
  ``SubmapFeatures``; on the card the four kernels), with its example
  arguments: 4 seeded sim pairs at capacity 16 with 32-d descriptors
  (__graft_entry__.py:16-60);
- ``dryrun_multichip(n, device=None)``: the pipeline's three sharded
  steps over an n-device mesh (``parallel.multichip``).
"""

from __future__ import annotations

import numpy as np
import torch

from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import RegistrationConfig, register_clipper
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.parallel.multichip import dryrun_multichip, make_pair_batch

__all__ = ["entry", "dryrun_multichip"]

ENTRY_CFG = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9)


def entry(device=None):
    """Returns (fn, example_args) on `device` (None: cuda; raises on a host
    without a card): fn(c1, r1, d1, v1, c2, r2, d2, v2) registers each
    pair of the batch and returns (sel, count, T_align)."""
    device = resolve_device(device)

    def fn(c1, r1, d1, v1, c2, r2, d2, v2):
        f1 = SubmapFeatures(centers=c1, ratio_feats=r1, descriptors=d1, valid=v1)
        f2 = SubmapFeatures(centers=c2, ratio_feats=r2, descriptors=d2, valid=v2)
        res = register_clipper(f1, f2, ENTRY_CFG)
        return res.sel, res.count, res.T_align

    s = make_pair_batch(P=4, cap=16, desc_dim=32)
    ratio1 = np.concatenate([s["pca1"], s["volume1"][..., None]], axis=-1)
    ratio2 = np.concatenate([s["pca2"], s["volume2"][..., None]], axis=-1)
    example_args = tuple(torch.as_tensor(x, device=device) for x in (
        s["centers1"], ratio1, s["desc1"], s["valid1"],
        s["centers2"], ratio2, s["desc2"], s["valid2"]))
    return fn, example_args
