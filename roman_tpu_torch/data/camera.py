"""Pinhole camera model and batched (de)projection.

Port of roman_tpu/data/camera.py, the stand-in for robotdatapy's
CameraParams / xyz_2_pixel / pixel_depth_2_xyz used by the reference
(segment.py:338-394, fastsam_wrapper.py:340-362). The projections are
torch functions over any batch of points or pixels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CameraParams:
    K: np.ndarray          # (3, 3) intrinsics
    width: int
    height: int
    D: np.ndarray | None = None  # distortion (unused: rectified inputs)

    @property
    def fx(self):
        return float(self.K[0, 0])

    @property
    def fy(self):
        return float(self.K[1, 1])

    @property
    def cx(self):
        return float(self.K[0, 2])

    @property
    def cy(self):
        return float(self.K[1, 2])

    @classmethod
    def simple(cls, width=640, height=480, f=500.0):
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
        return cls(K=K, width=width, height=height)


def xyz_to_pixel(points: torch.Tensor, K) -> torch.Tensor:
    """(..., n, 3) camera-frame points -> (..., n, 2) [u, v] pixels."""
    z = torch.clamp(points[..., 2], min=1e-9)
    u = K[0, 0] * points[..., 0] / z + K[0, 2]
    v = K[1, 1] * points[..., 1] / z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def pixel_depth_to_xyz(u: torch.Tensor, v: torch.Tensor, depth: torch.Tensor,
                       K) -> torch.Tensor:
    """Pixels and depth -> camera-frame xyz (..., 3): x = (u - cx) * (1 /
    fx) * depth, roman_tpu's (u - cx) / fx * depth as XLA evaluates it in a
    jit, where K is a constant and the division is folded into a multiply
    (with K a float32 tensor the two agree to the bit; plain division
    differs in the last bit, which moves points on a voxel boundary)."""
    x = (u - K[0, 2]) * (1.0 / K[0, 0]) * depth
    y = (v - K[1, 2]) * (1.0 / K[1, 1]) * depth
    return torch.stack([x, y, depth], dim=-1)


def depth_image_to_points(depth: torch.Tensor, K) -> torch.Tensor:
    """(..., H, W) depth image -> (..., H, W, 3) camera-frame points (z
    forward): the whole point image at once, which masks then gather from
    (fastsam_wrapper.py:340-362)."""
    H, W = depth.shape[-2], depth.shape[-1]
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device), indexing="ij")
    return pixel_depth_to_xyz(u, v, depth, K)
