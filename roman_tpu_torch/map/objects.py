"""Alternative object representations for synthetic/simulation studies.

Parity with reference roman/object/{object,pointcloud_object,ellipsoid,
mesh_object,polytope}.py: a common Object base (centroid/dim/id/volume,
transform, add_noise) and the experimental types used in the paper's
synthetic registration studies. A host copy of roman_tpu/map/objects.py:
numpy-backed host data (these are data generators, not hot paths).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ObjectBase:
    """Reference roman/object/object.py:6-67."""

    centroid: np.ndarray
    dim: int = 3
    id: int = 0
    volume: float = 0.0

    @property
    def center(self) -> np.ndarray:
        return np.asarray(self.centroid).reshape(-1)

    def transform(self, T: np.ndarray):
        c = np.asarray(self.centroid).reshape(-1)[: self.dim]
        self.centroid = T[: self.dim, : self.dim] @ c + T[: self.dim, self.dim]

    def add_noise(self, rng, centroid_std: float = 0.0):
        self.centroid = (
            np.asarray(self.centroid).reshape(-1)
            + rng.normal(size=self.dim) * centroid_std
        )

    def copy(self):
        return dataclasses.replace(self)


@dataclasses.dataclass
class Ellipsoid(ObjectBase):
    """Axis-aligned-principal ellipsoid (reference ellipsoid.py)."""

    axes: np.ndarray = None       # (3,) semi-axes
    R: np.ndarray = None          # (3, 3) orientation

    def __post_init__(self):
        if self.axes is None:
            self.axes = np.ones(3)
        if self.R is None:
            self.R = np.eye(3)
        self.volume = float(4.0 / 3.0 * np.pi * np.prod(self.axes))

    def transform(self, T: np.ndarray):
        super().transform(T)
        self.R = T[:3, :3] @ self.R

    def sample_surface(self, rng, n: int = 100) -> np.ndarray:
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        return (u * self.axes) @ self.R.T + self.center

    @classmethod
    def random(cls, rng, id=0, area=(10.0, 10.0, 3.0), axis_range=(0.2, 1.5)):
        from scipy.spatial.transform import Rotation as Rot

        return cls(
            centroid=rng.uniform(size=3) * np.asarray(area),
            id=id,
            axes=rng.uniform(*axis_range, size=3),
            R=Rot.random(random_state=int(rng.integers(1 << 30))).as_matrix(),
        )


@dataclasses.dataclass
class Polytope(ObjectBase):
    """Random convex polytope from sampled points (reference polytope.py)."""

    vertices: np.ndarray = None   # (k, 3)

    def __post_init__(self):
        if self.vertices is not None:
            self._update()

    def _update(self):
        from scipy.spatial import ConvexHull

        hull = ConvexHull(self.vertices)
        self.vertices = self.vertices[hull.vertices]
        self.volume = float(hull.volume)
        self.centroid = self.vertices.mean(axis=0)

    def transform(self, T: np.ndarray):
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        self.centroid = self.vertices.mean(axis=0)

    @classmethod
    def random(cls, rng, id=0, n_points: int = 12, scale: float = 1.0,
               area=(10.0, 10.0, 3.0)):
        c = rng.uniform(size=3) * np.asarray(area)
        pts = c + rng.normal(size=(n_points, 3)) * scale
        return cls(centroid=c, id=id, vertices=pts)


@dataclasses.dataclass
class MeshObject(ObjectBase):
    """Triangle-mesh object; volume by signed tetrahedra (reference
    mesh_object.py, o3d-free)."""

    vertices: np.ndarray = None   # (v, 3)
    faces: np.ndarray = None      # (f, 3) int

    def __post_init__(self):
        if self.vertices is not None and self.faces is not None:
            self.volume = self._signed_volume()
            self.centroid = self.vertices.mean(axis=0)

    def _signed_volume(self) -> float:
        v = self.vertices
        f = self.faces
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        return float(abs(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0))

    def transform(self, T: np.ndarray):
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        self.centroid = self.vertices.mean(axis=0)

    def sample_surface(self, rng, n: int = 200) -> np.ndarray:
        v, f = self.vertices, self.faces
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        probs = areas / areas.sum()
        tri = rng.choice(len(f), size=n, p=probs)
        r1 = np.sqrt(rng.uniform(size=(n, 1)))
        r2 = rng.uniform(size=(n, 1))
        return (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]


class PointCloudObject(ObjectBase):
    """Point-cloud-backed object with partial-view simulation (reference
    pointcloud_object.py:156-378)."""

    def __init__(self, points: np.ndarray, id: int = 0):
        self.points = np.asarray(points)
        super().__init__(centroid=self.points.mean(axis=0), dim=3, id=id)
        self._update_volume()

    def _update_volume(self):
        # voxel-sampled volume estimate (pointcloud_object.py:359-378)
        from roman_tpu_torch.ops.voxel import voxel_set

        vs = 0.1
        self.volume = len(voxel_set(self.points, vs)) * vs**3

    def transform(self, T: np.ndarray):
        self.points = self.points @ T[:3, :3].T + T[:3, 3]
        self.centroid = self.points.mean(axis=0)

    def partial_view(self, viewpoint: np.ndarray, keep_frac: float = 0.6,
                     rng=None) -> "PointCloudObject":
        """Keep the points facing a viewpoint (partial-view simulation,
        pointcloud_object.py:156-204)."""
        rng = rng or np.random.default_rng(0)
        d = self.points - np.asarray(viewpoint)
        depth = np.linalg.norm(d, axis=1)
        order = np.argsort(depth)
        k = max(int(len(order) * keep_frac), 4)
        return PointCloudObject(self.points[order[:k]], id=self.id)

    def add_noise(self, rng, centroid_std: float = 0.0, point_std: float = 0.0):
        if point_std > 0:
            self.points = self.points + rng.normal(size=self.points.shape) * point_std
        if centroid_std > 0:
            self.points = self.points + rng.normal(size=3) * centroid_std
        self.centroid = self.points.mean(axis=0)
        self._update_volume()
