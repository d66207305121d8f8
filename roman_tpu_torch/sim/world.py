"""Synthetic multi-robot object worlds for tests and benchmarks (a numpy
copy of roman_tpu/sim/world.py that drives the port's own map types).

The reference has no unit tests and validates only end-to-end on recorded
Kimera-Multi data (SURVEY §4). That data is not available here, so this
module generates controlled worlds with known ground truth: objects with
centers, shape attributes and semantic descriptors; robot trajectories
traversing them; per-robot observed maps with noise, dropout and clutter.
Ground-truth associations, relative transforms and trajectories let every
stage (registration, alignment, loop closures, pose-graph optimization,
ATE) be scored exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PairProblem:
    """A single submap-pair registration problem with ground truth."""

    centers1: np.ndarray      # (n1, 3)
    centers2: np.ndarray      # (n2, 3)
    pca1: np.ndarray          # (n1, 3) linearity/planarity/scattering
    pca2: np.ndarray
    volume1: np.ndarray       # (n1,)
    volume2: np.ndarray
    extent1: np.ndarray       # (n1, 3)
    extent2: np.ndarray
    desc1: np.ndarray         # (n1, D) unit
    desc2: np.ndarray
    gt_assoc: np.ndarray      # (k, 2) indices (i in map1, j in map2)
    T_gt: np.ndarray          # (4, 4): centers1 ~= T_gt @ centers2


def _unit(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def random_objects(rng, n, area=(40.0, 40.0, 3.0), n_classes=32, desc_dim=768,
                   instance_noise=0.25):
    centers = rng.uniform(size=(n, 3)) * np.asarray(area)
    # shape eigenvalue profiles -> attributes
    e = np.sort(rng.uniform(0.05, 1.0, size=(n, 3)), axis=1)[:, ::-1]
    e = e / e.sum(axis=1, keepdims=True)
    pca = np.stack(
        [(e[:, 0] - e[:, 1]) / e[:, 0], (e[:, 1] - e[:, 2]) / e[:, 0], e[:, 2] / e[:, 0]],
        axis=1,
    )
    volume = rng.lognormal(mean=0.0, sigma=0.7, size=n) + 0.1
    extent = np.sort(rng.lognormal(mean=0.0, sigma=0.5, size=(n, 3)), axis=1)
    protos = _unit(rng.normal(size=(n_classes, desc_dim)))
    cls = rng.integers(0, n_classes, size=n)
    # class prototype + an instance-specific offset, with noise norms (not
    # per-component sigmas) controlled so the structure is comparable across
    # descriptor dimensions: same-instance cross-view cosine ~0.97+,
    # same-class different-instance ~0.85 (DINO-like discriminability)
    desc = _unit(protos[cls] + instance_noise * _unit(rng.normal(size=(n, desc_dim))))
    return dict(centers=centers, pca=pca, volume=volume, extent=extent, desc=desc,
                cls=cls, protos=protos)


def yaw_T(yaw: float, t: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def make_pair_problem(
    rng,
    n_common: int = 20,
    n_only1: int = 10,
    n_only2: int = 10,
    center_noise: float = 0.1,
    desc_noise: float = 0.1,
    shape_noise: float = 0.05,
    yaw: float | None = None,
    translation_scale: float = 10.0,
    desc_dim: int = 768,
    area=(30.0, 30.0, 3.0),
    dup_frac: float = 0.0,
    symmetric: bool = False,
) -> PairProblem:
    """Two views of a shared scene related by a yaw+translation (submap
    frames are gravity-aligned in the reference, map.py:106-111, so the true
    inter-submap transform is yaw-only).

    Adversarial nuisances (alignment-quality sweeps):
    - dup_frac: fraction of the common objects DUPLICATED at mirrored
      positions in both views with identical descriptors/shape —
      repetitive-structure aliasing that tempts clone-to-original
      matches.
    - symmetric: lay the common objects out mirror-symmetrically about
      the area's x-axis (each object gets a twin), creating a global
      180-degree ambiguity.
    """
    world = random_objects(rng, n_common + n_only1 + n_only2, area=area, desc_dim=desc_dim)
    if symmetric and n_common >= 2:
        # second half of the common set = mirror twins of the first half
        # (same shape/descriptor, reflected placement)
        h = n_common // 2
        mirror = world["centers"][:h].copy()
        mirror[:, 1] = area[1] - mirror[:, 1]
        world["centers"][h: 2 * h] = mirror
        for key in ("pca", "volume", "extent", "desc", "cls"):
            world[key][h: 2 * h] = world[key][:h]
    n_dup = int(round(dup_frac * n_common))
    if n_dup > 0:
        # clones live at mirrored positions and are visible in BOTH
        # views (appended after the common block so they are never part
        # of the GT association set)
        src = rng.choice(n_common, size=n_dup, replace=False)
        clone_centers = world["centers"][src].copy()
        clone_centers[:, 0] = area[0] - clone_centers[:, 0]
        clone_centers[:, 1] = area[1] - clone_centers[:, 1]
        for key, cl in (("centers", clone_centers),):
            world[key] = np.concatenate([world[key], cl], axis=0)
        for key in ("pca", "volume", "extent", "desc", "cls"):
            world[key] = np.concatenate([world[key], world[key][src]], axis=0)
    if yaw is None:
        yaw = rng.uniform(-np.pi, np.pi)
    t = np.concatenate([rng.uniform(-1.0, 1.0, 2) * translation_scale, rng.uniform(-0.5, 0.5, 1)])
    T_gt = yaw_T(yaw, t)
    T_inv = np.linalg.inv(T_gt)

    idx1 = np.arange(n_common + n_only1)
    idx2 = np.concatenate([np.arange(n_common), np.arange(n_common + n_only1, n_common + n_only1 + n_only2)])
    if n_dup > 0:
        clones = np.arange(n_common + n_only1 + n_only2,
                           n_common + n_only1 + n_only2 + n_dup)
        idx1 = np.concatenate([idx1, clones])
        idx2 = np.concatenate([idx2, clones])

    def view(idx, transform):
        c = world["centers"][idx]
        if transform is not None:
            c = c @ transform[:3, :3].T + transform[:3, 3]
        c = c + rng.normal(size=c.shape) * center_noise
        pca = np.clip(world["pca"][idx] * (1 + rng.normal(size=(len(idx), 3)) * shape_noise), 1e-3, 1.0)
        vol = world["volume"][idx] * (1 + rng.normal(size=len(idx)) * shape_noise)
        ext = world["extent"][idx] * (1 + rng.normal(size=(len(idx), 3)) * shape_noise)
        dn = _unit(rng.normal(size=(len(idx), world["desc"].shape[1]))) * desc_noise
        desc = _unit(world["desc"][idx] + dn)
        return c, pca, np.abs(vol), np.abs(ext), desc

    c1, pca1, vol1, ext1, d1 = view(idx1, None)
    c2, pca2, vol2, ext2, d2 = view(idx2, T_inv)

    perm2 = rng.permutation(len(idx2))
    inv_perm2 = np.argsort(perm2)
    gt = np.stack([np.arange(n_common), inv_perm2[:n_common]], axis=1)

    return PairProblem(
        centers1=c1, centers2=c2[perm2],
        pca1=pca1, pca2=pca2[perm2],
        volume1=vol1, volume2=vol2[perm2],
        extent1=ext1, extent2=ext2[perm2],
        desc1=d1, desc2=d2[perm2],
        gt_assoc=gt, T_gt=T_gt,
    )


def pad_problem(p: PairProblem, capacity: int):
    """Pad a PairProblem to fixed capacity; returns dict of arrays + masks."""
    def pad(x, n):
        out = np.zeros((capacity,) + x.shape[1:], dtype=np.float32)
        out[:n] = x
        return out

    n1, n2 = len(p.centers1), len(p.centers2)
    assert n1 <= capacity and n2 <= capacity
    return dict(
        centers1=pad(p.centers1, n1), centers2=pad(p.centers2, n2),
        pca1=pad(p.pca1, n1), pca2=pad(p.pca2, n2),
        volume1=pad(p.volume1, n1), volume2=pad(p.volume2, n2),
        extent1=pad(p.extent1, n1), extent2=pad(p.extent2, n2),
        desc1=pad(p.desc1, n1), desc2=pad(p.desc2, n2),
        valid1=np.arange(capacity) < n1, valid2=np.arange(capacity) < n2,
    )


# ---------------------------------------------------------------------------
# Full multi-robot worlds (trajectories + per-robot maps) for end-to-end
# pipeline tests and the benchmark.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RobotRun:
    times: np.ndarray          # (T,)
    poses: np.ndarray          # (T, 4, 4) ground-truth FLU poses
    odom_poses: np.ndarray     # (T, 4, 4) drifted odometry
    seg_centers: np.ndarray    # (K, 3) observed object centers (odom frame)
    seg_pca: np.ndarray
    seg_volume: np.ndarray
    seg_extent: np.ndarray
    seg_desc: np.ndarray
    seg_first_seen: np.ndarray
    seg_last_seen: np.ndarray
    seg_world_id: np.ndarray   # (K,) ground-truth world object id


def roman_map_from_run(run: "RobotRun"):
    """Convert a simulated RobotRun into a RomanMap artifact (the mapping
    stage's output format, map.py:18-41)."""
    from roman_tpu_torch.map.roman_map import RomanMap, SegmentData

    segments = [
        SegmentData(
            id=int(i),
            center=run.seg_centers[i],
            volume=float(run.seg_volume[i]),
            linearity=float(run.seg_pca[i, 0]),
            planarity=float(run.seg_pca[i, 1]),
            scattering=float(run.seg_pca[i, 2]),
            extent=run.seg_extent[i],
            semantic_descriptor=run.seg_desc[i],
            first_seen=float(run.seg_first_seen[i]),
            last_seen=float(run.seg_last_seen[i]),
        )
        for i in range(len(run.seg_centers))
    ]
    return RomanMap(
        segments=segments,
        trajectory=run.odom_poses,
        times=run.times,
        descriptors=None,
        poses_are_flu=True,
    )


def write_gt_csv(run: "RobotRun", path: str):
    """TUM-format ground truth trajectory file."""
    from roman_tpu_torch.ops import se3_np

    t, q = se3_np.T_to_xyz_quat(run.poses)
    data = np.concatenate([run.times[:, None], t, q], axis=1)
    np.savetxt(path, data)


def make_multi_robot_world(
    rng,
    n_robots: int = 2,
    n_objects: int = 400,
    area=(120.0, 120.0, 4.0),
    traj_len: float = 240.0,
    speed: float = 1.0,
    dt: float = 1.0 / 6.0,
    view_radius: float = 12.0,
    p_detect: float = 0.85,
    center_noise: float = 0.1,
    desc_noise: float = 0.1,
    shape_noise: float = 0.05,
    odom_drift_per_m: float = 0.01,
    desc_dim: int = 64,
    n_classes: int = 32,
    instance_noise: float = 0.25,
):
    """Robots drive smooth random paths through a shared object field.

    Each robot's map holds the objects that came within view_radius of its
    path (detection probability p_detect), expressed in its own *drifted
    odometry frame* — exactly the input situation of the reference's
    submap_align stage (maps in per-robot odom frames + GT poses for
    evaluation, submap_align.py:41-65).
    """
    world = random_objects(rng, n_objects, area=area, desc_dim=desc_dim,
                           n_classes=n_classes, instance_noise=instance_noise)
    n_steps = int(traj_len / speed / dt)
    runs = []
    for r in range(n_robots):
        # smooth random walk in 2D
        heading = rng.uniform(0, 2 * np.pi)
        pos = np.array([rng.uniform(0.2, 0.8) * area[0], rng.uniform(0.2, 0.8) * area[1], 1.0])
        poses = np.zeros((n_steps, 4, 4))
        times = np.arange(n_steps) * dt
        for k in range(n_steps):
            heading += rng.normal() * 0.05
            # bounce off area bounds
            if not (5 < pos[0] < area[0] - 5):
                heading = np.pi - heading
            if not (5 < pos[1] < area[1] - 5):
                heading = -heading
            pos = pos + np.array([np.cos(heading), np.sin(heading), 0.0]) * speed * dt
            poses[k] = yaw_T(heading, pos)

        # drifted odometry: integrate relative poses with noise
        odom = np.zeros_like(poses)
        odom[0] = poses[0]
        for k in range(1, n_steps):
            rel = np.linalg.inv(poses[k - 1]) @ poses[k]
            d = np.linalg.norm(rel[:3, 3])
            noise = yaw_T(rng.normal() * odom_drift_per_m * d * 3.0,
                          rng.normal(size=3) * odom_drift_per_m * d * [1, 1, 0.2])
            odom[k] = odom[k - 1] @ rel @ noise

        # observed objects
        dists = np.linalg.norm(
            world["centers"][None, :, :2] - poses[:, None, :2, 3], axis=-1
        )  # (T, K)
        seen = dists < view_radius
        first = np.argmax(seen, axis=0)
        last = n_steps - 1 - np.argmax(seen[::-1], axis=0)
        ever = seen.any(axis=0) & (rng.uniform(size=n_objects) < p_detect)
        ids = np.flatnonzero(ever)

        # express centers in the odom frame: world -> gt body -> odom
        # using the pose at the midpoint sighting as anchor
        anchor = ((first + last) // 2)[ids]
        c_world = world["centers"][ids]
        c_odom = np.zeros_like(c_world)
        for ii, (oid, ak) in enumerate(zip(ids, anchor)):
            T_body_world = np.linalg.inv(poses[ak])
            c_body = T_body_world[:3, :3] @ c_world[ii] + T_body_world[:3, 3]
            c_odom[ii] = odom[ak, :3, :3] @ c_body + odom[ak, :3, 3]
        c_odom = c_odom + rng.normal(size=c_odom.shape) * center_noise

        k = len(ids)
        runs.append(
            RobotRun(
                times=times,
                poses=poses,
                odom_poses=odom,
                seg_centers=c_odom,
                seg_pca=np.clip(world["pca"][ids] * (1 + rng.normal(size=(k, 3)) * shape_noise), 1e-3, 1.0),
                seg_volume=np.abs(world["volume"][ids] * (1 + rng.normal(size=k) * shape_noise)),
                seg_extent=np.abs(world["extent"][ids] * (1 + rng.normal(size=(k, 3)) * shape_noise)),
                seg_desc=_unit(world["desc"][ids]
                               + _unit(rng.normal(size=(k, world["desc"].shape[1]))) * desc_noise),
                seg_first_seen=times[first[ids]],
                seg_last_seen=times[last[ids]],
                seg_world_id=ids,
            )
        )
    return world, runs
