"""Image resampling with the semantics of ``jax.image.resize`` and
``jax.image.scale_and_translate``, for NCHW tensors.

The perception front end of roman_tpu resizes with JAX's defaults:
``"bilinear"`` is a triangle kernel on half-pixel centres that is widened
by 1/scale when shrinking (antialiasing), which is
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``;
``"nearest"`` takes the pixel whose centre is nearest with half-pixel
centres, as ``mode="nearest-exact"`` does, but with JAX's float32
arithmetic for the source index, so ties between two pixels fall the same
way (``mode="nearest"`` floors the unshifted coordinate and picks other
pixels). The per-crop resampling of
the CLIP path has a scale and a shift per box, so it builds JAX's 1-D
weight matrices (``compute_weight_mat``) and applies them as two batched
products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, h, w): jax.image.resize(..., "bilinear") over
    the two trailing axes (antialiased when shrinking)."""
    h, w = int(size[0]), int(size[1])
    if (h, w) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    # floor((i + 0.5) * in / out) in float32 as XLA evaluates JAX's
    # expression: in / out folded into in * (1 / out), each rounded to
    # float32. Where (i + 0.5) * in / out is a whole number the rounding
    # decides between two pixels, and F.interpolate's nearest-exact rounds
    # another way.
    one = torch.ones((), dtype=torch.float32, device=device)
    ratio = (one / out_size) * in_size
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * ratio).to(torch.int64)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, h, w): jax.image.resize(..., "nearest") over
    the two trailing axes (the input pixel whose centre is nearest, with
    half-pixel centres)."""
    H, W = x.shape[-2:]
    h, w = int(size[0]), int(size[1])
    if h != H:
        x = x.index_select(-2, _nearest_index(H, h, x.device))
    if w != W:
        x = x.index_select(-1, _nearest_index(W, w, x.device))
    return x


def linear_weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """JAX's compute_weight_mat for the triangle kernel with antialiasing,
    batched over the leading shape of `scale` and `translation`:
    (...,) -> (..., out_size, in_size) weights that map an input line to
    an output line under x_out = x_in * scale + translation (half-pixel
    centres)."""
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)[..., None, None]
    out_idx = torch.arange(out_size, dtype=scale.dtype, device=scale.device)
    in_idx = torch.arange(in_size, dtype=scale.dtype, device=scale.device)
    sample_f = ((out_idx + 0.5) * inv_scale[..., None]
                - (translation * inv_scale)[..., None] - 0.5)    # (..., out)
    x = (sample_f[..., :, None] - in_idx).abs() / kernel_scale  # (..., out, in)
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=-1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None], weights, torch.zeros_like(weights))


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Crop each box from its frame and resample it to out_size x out_size:
    jax.image.scale_and_translate(img, (S, S, C), (0, 1, 2), (S/h, S/w, 1),
    (-y1*S/h, -x1*S/w, 0), "linear") for every box.

    images (B, C, H, W) float; boxes (B, K, 4) xyxy pixels. Returns
    (B, K, C, S, S).
    """
    B, C, H, W = images.shape
    K, S = boxes.shape[1], out_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    wy = linear_weight_mat(H, S, S / h, -y1 * S / h)          # (B, K, S, H)
    wx = linear_weight_mat(W, S, S / w, -x1 * S / w)          # (B, K, S, W)
    # rows of every crop at once: (B, K*S, H) @ (B, H, C*W)
    rows = torch.bmm(wy.reshape(B, K * S, H),
                     images.permute(0, 2, 1, 3).reshape(B, H, C * W))
    rows = rows.reshape(B * K, S * C, W)
    out = torch.bmm(rows, wx.reshape(B * K, S, W).transpose(1, 2))  # (B*K, S*C, S)
    return out.reshape(B, K, S, C, S).permute(0, 1, 3, 2, 4)
