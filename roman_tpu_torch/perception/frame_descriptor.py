"""Frame descriptors from DINOv2 patch features: a port of
roman_tpu/perception/frame_descriptor.py.

Parity with reference FastSAMWrapper.get_frame_descriptor
(fastsam_wrapper.py:650-666): gap (global average pool), gmp (global max
pool), gem (the reference's signed generalized mean, p=3) over the patch
grid, each L2-normalized.
"""

from __future__ import annotations

import torch


def frame_descriptor(patches: torch.Tensor, kind: str = "dino-gem",
                     gem_p: float = 3.0) -> torch.Tensor:
    """patches (..., gh, gw, D) -> (..., D), L2-normalized. gem is mean(x^p)
    per channel, then sign(.)*|.|^(1/p) (fastsam_wrapper.py:658-661)."""
    flat = patches.reshape(patches.shape[:-3] + (-1, patches.shape[-1]))
    kind = kind.split("-")[-1]
    if kind == "gap":
        d = flat.mean(dim=-2)
    elif kind == "gmp":
        d = flat.max(dim=-2).values
    elif kind == "gem":
        cubed = (flat ** gem_p).mean(dim=-2)
        d = torch.sign(cubed) * torch.clamp(cubed.abs(), min=1e-12) ** (1.0 / gem_p)
    else:
        raise ValueError(f"unknown frame descriptor {kind!r}")
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def masked_mean_embedding(pixel_features: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Per-mask mean of per-pixel features: pixel_features (H, W, D), masks
    (M, H, W) bool -> (M, D) (reference fastsam_wrapper.py:407-414)."""
    m = masks.to(pixel_features.dtype)
    num = torch.einsum("mhw,hwd->md", m, pixel_features)
    den = torch.clamp(m.sum(dim=(-2, -1)), min=1.0)
    return num / den[..., None]
