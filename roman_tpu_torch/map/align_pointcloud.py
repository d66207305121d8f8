"""Range-sensor ingestion: a motion-compensated point cloud rendered as a
sparse depth image in the camera.

Port of roman_tpu/map/align_pointcloud.py (reference
roman/map/align_pointcloud.py): the pose is interpolated between the cloud
and image times (:59-97), points are projected into the pinhole camera
(:99-115) and the in-frame ones kept (:117-130). A batch of (cloud,
image time) pairs is rendered at once, as a z-buffer by a scatter-min, so
the depth-based mask lifting is reused unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.ops import se3


@dataclasses.dataclass
class AlignPointCloudParams:
    max_range: float = 60.0
    z_near: float = 0.05


class AlignPointCloud:
    """T_camera_rangesense: the static extrinsics (the reference reads
    them from the bag's TF, :43-57; here they are passed in)."""

    def __init__(self, camera: CameraParams, T_camera_rangesense: np.ndarray,
                 pose_data: Optional[PoseData] = None,
                 params: AlignPointCloudParams = AlignPointCloudParams(),
                 device=None):
        self.camera = camera
        self.T_camera_rangesense = np.asarray(T_camera_rangesense)
        self.pose_data = pose_data
        self.params = params
        self.device = resolve_device(device)

    def render(self, points: torch.Tensor, valid: torch.Tensor,
               T_comp: torch.Tensor) -> torch.Tensor:
        """points (B, n, 3) in the range sensor's frame at cloud time,
        valid (B, n), T_comp (B, 4, 4) the motion compensation -> sparse
        depth images (B, H, W), 0 where no point lands."""
        dev = points.device
        K = torch.as_tensor(self.camera.K, dtype=torch.float32, device=dev)
        W, H = self.camera.width, self.camera.height
        T_cr = torch.as_tensor(self.T_camera_rangesense, dtype=torch.float32, device=dev)
        pts_cam = se3.apply_T(T_comp @ T_cr, points)
        z = pts_cam[..., 2]
        zc = torch.clamp(z, min=1e-6)
        u = K[0, 0] * pts_cam[..., 0] / zc + K[0, 2]
        v = K[1, 1] * pts_cam[..., 1] / zc + K[1, 2]
        ok = (valid & (z > self.params.z_near) & (z < self.params.max_range)
              & (u >= 0) & (u < W) & (v >= 0) & (v < H))
        ui = torch.clamp(u.to(torch.int32), 0, W - 1).to(torch.int64)
        vi = torch.clamp(v.to(torch.int32), 0, H - 1).to(torch.int64)
        flat = vi * W + ui
        zb = torch.where(ok, z, torch.full_like(z, float("inf")))
        depth = torch.full((points.shape[0], H * W), float("inf"),
                           dtype=torch.float32, device=dev)
        depth.scatter_reduce_(1, flat, zb, reduce="amin")
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        return depth.reshape(-1, H, W)

    def compensation_transform(self, t_cloud: float, t_img: float) -> np.ndarray:
        """The transform taking cloud-time camera points to the image-time
        camera frame, by interpolated body poses (reference :59-97)."""
        if self.pose_data is None:
            raise ValueError("motion compensation needs pose_data")
        T_w_img = self.pose_data.pose(t_img)
        T_w_cld = self.pose_data.pose(t_cloud)
        return np.linalg.inv(T_w_img) @ T_w_cld

    def depth_images(self, points: np.ndarray, valid: np.ndarray,
                     t_clouds, t_imgs) -> np.ndarray:
        """points (B, n, 3), valid (B, n) -> (B, H, W) sparse depth."""
        B = points.shape[0]
        T_comp = np.stack([
            self.compensation_transform(tc, ti) for tc, ti in zip(t_clouds, t_imgs)
        ]) if self.pose_data is not None else np.tile(np.eye(4), (B, 1, 1))
        dev = self.device
        return self.render(
            torch.as_tensor(np.asarray(points, np.float32), device=dev),
            torch.as_tensor(np.asarray(valid, bool), device=dev),
            torch.as_tensor(np.asarray(T_comp, np.float32), device=dev)).cpu().numpy()
