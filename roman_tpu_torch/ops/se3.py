"""Batched SE(3) helpers on tensors (port of the parts of
roman_tpu/ops/se3.py the alignment stage uses). Everything broadcasts over
leading batch dimensions."""

from __future__ import annotations

import torch


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def T_to_xyzrpy(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [x y z roll pitch yaw], 'ZYX' intrinsic
    euler (roman_tpu/ops/se3.py:143-154)."""
    R = T[..., :3, :3]
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.cat(
        [T[..., :3, 3], torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)
