"""The align cells' inputs: two robots' object maps, cut into submaps and
packed, made from the scene's seed.

A frozen copy of the port's ``sim/world.py`` (``random_objects``,
``make_multi_robot_world``) and of the submap partition and packing of
``map/roman_map.py`` (``submaps_from_roman_map`` without force-fill,
``submaps_to_features``), rewritten on plain numpy so that the benchmark
makes its inputs itself: the program and the reference are handed the
same arrays, and neither derives them. The random draws are made in the
same order as the port's, so a seed gives the port's world.

The feature layout is the ROMAN method's (reference
roman/align/roman_registration.py:98-108): ratio features
[linearity, planarity, scattering, volume], unit semantic descriptors.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _unit(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def _yaw_T(yaw: float, t) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _rm_roll_pitch(T: np.ndarray) -> np.ndarray:
    """The yaw-only projection of a pose (reference roman/utils.py:128-130)."""
    yaw = np.arctan2(T[1, 0], T[0, 0])
    return _yaw_T(yaw, T[:3, 3])


def _random_objects(rng, n, area, n_classes, desc_dim, instance_noise):
    centers = rng.uniform(size=(n, 3)) * np.asarray(area)
    e = np.sort(rng.uniform(0.05, 1.0, size=(n, 3)), axis=1)[:, ::-1]
    e = e / e.sum(axis=1, keepdims=True)
    pca = np.stack([(e[:, 0] - e[:, 1]) / e[:, 0], (e[:, 1] - e[:, 2]) / e[:, 0],
                    e[:, 2] / e[:, 0]], axis=1)
    volume = rng.lognormal(mean=0.0, sigma=0.7, size=n) + 0.1
    extent = np.sort(rng.lognormal(mean=0.0, sigma=0.5, size=(n, 3)), axis=1)
    protos = _unit(rng.normal(size=(n_classes, desc_dim)))
    cls = rng.integers(0, n_classes, size=n)
    desc = _unit(protos[cls] + instance_noise * _unit(rng.normal(size=(n, desc_dim))))
    return dict(centers=centers, pca=pca, volume=volume, extent=extent, desc=desc)


@dataclasses.dataclass
class Run:
    """One robot's drive: its odometry poses, and the objects it mapped, in
    its odometry frame."""

    times: np.ndarray        # (T,)
    odom: np.ndarray         # (T, 4, 4) drifted odometry
    centers: np.ndarray      # (K, 3)
    pca: np.ndarray          # (K, 3)
    volume: np.ndarray       # (K,)
    desc: np.ndarray         # (K, D) unit
    first_seen: np.ndarray   # (K,)
    last_seen: np.ndarray    # (K,)


def make_runs(rng, scene: dict) -> list:
    """The robots' runs through one seeded object field (the port's
    sim.world.make_multi_robot_world, draw for draw)."""
    area = tuple(scene["area_m"])
    n_objects = scene["n_objects"]
    speed, dt = scene["speed_m_s"], scene["dt_s"]
    drift = scene["odom_drift_per_m"]
    world = _random_objects(rng, n_objects, area, scene["n_classes"],
                            scene["desc_dim"], scene["instance_noise"])
    n_steps = int(scene["traj_len_m"] / speed / dt)
    runs = []
    for _ in range(scene["n_robots"]):
        heading = rng.uniform(0, 2 * np.pi)
        pos = np.array([rng.uniform(0.2, 0.8) * area[0],
                        rng.uniform(0.2, 0.8) * area[1], 1.0])
        poses = np.zeros((n_steps, 4, 4))
        times = np.arange(n_steps) * dt
        for k in range(n_steps):
            heading += rng.normal() * 0.05
            if not (5 < pos[0] < area[0] - 5):
                heading = np.pi - heading
            if not (5 < pos[1] < area[1] - 5):
                heading = -heading
            pos = pos + np.array([np.cos(heading), np.sin(heading), 0.0]) * speed * dt
            poses[k] = _yaw_T(heading, pos)
        odom = np.zeros_like(poses)
        odom[0] = poses[0]
        for k in range(1, n_steps):
            rel = np.linalg.inv(poses[k - 1]) @ poses[k]
            d = np.linalg.norm(rel[:3, 3])
            noise = _yaw_T(rng.normal() * drift * d * 3.0,
                           rng.normal(size=3) * drift * d * np.array([1, 1, 0.2]))
            odom[k] = odom[k - 1] @ rel @ noise
        dists = np.linalg.norm(world["centers"][None, :, :2] - poses[:, None, :2, 3],
                               axis=-1)
        seen = dists < scene["view_radius_m"]
        first = np.argmax(seen, axis=0)
        last = n_steps - 1 - np.argmax(seen[::-1], axis=0)
        ever = seen.any(axis=0) & (rng.uniform(size=n_objects) < scene["p_detect"])
        ids = np.flatnonzero(ever)
        anchor = ((first + last) // 2)[ids]
        c_odom = np.zeros((len(ids), 3))
        for ii, (oid, ak) in enumerate(zip(ids, anchor)):
            T_body_world = np.linalg.inv(poses[ak])
            c_body = T_body_world[:3, :3] @ world["centers"][oid] + T_body_world[:3, 3]
            c_odom[ii] = odom[ak, :3, :3] @ c_body + odom[ak, :3, 3]
        c_odom = c_odom + rng.normal(size=c_odom.shape) * scene["center_noise_m"]
        k = len(ids)
        noise = scene["shape_noise"]
        pca = np.clip(world["pca"][ids] * (1 + rng.normal(size=(k, 3)) * noise), 1e-3, 1.0)
        volume = np.abs(world["volume"][ids] * (1 + rng.normal(size=k) * noise))
        rng.normal(size=(k, 3))  # the port's world draws each extent here
        desc = _unit(world["desc"][ids] + _unit(rng.normal(size=(k, world["desc"].shape[1])))
                     * scene["desc_noise"])
        runs.append(Run(times=times, odom=odom, centers=c_odom, pca=pca,
                        volume=volume, desc=desc, first_seen=times[first[ids]],
                        last_seen=times[last[ids]]))
    return runs


@dataclasses.dataclass
class Submaps:
    """One robot's submaps, packed to a fixed capacity."""

    centers: np.ndarray     # (S, cap, 3) in each submap's gravity-aligned frame
    ratio: np.ndarray       # (S, cap, 4) linearity, planarity, scattering, volume
    desc: np.ndarray        # (S, cap, D) unit
    valid: np.ndarray       # (S, cap) bool
    ids: np.ndarray         # (S, cap) the objects' indices in the run, -1 for padding

    @property
    def sizes(self) -> np.ndarray:
        return self.valid.sum(axis=1)


def make_submaps(run: Run, align: dict) -> Submaps:
    """A submap every `submap_center_dist` m of odometry, holding the
    objects within `submap_radius` m of its center, pruned to the
    `submap_max_size` nearest in time (the reference
    roman/map/map.py:300-339 with pruning by time and no time window)."""
    cap = align["submap_max_size"]
    radius = align["submap_radius"]
    dist = align["submap_center_dist"]
    centers_idx = []
    for i, pose in enumerate(run.odom):
        if i == 0 or np.linalg.norm(pose[:3, 3] - run.odom[centers_idx[-1]][:3, 3]) > dist:
            centers_idx.append(i)
    ref_time = (run.first_seen + run.last_seen) / 2.0
    out = []
    for k in centers_idx:
        t = run.times[k]
        in_radius = np.linalg.norm(run.centers - run.odom[k][:3, 3], axis=1) < radius
        members = np.flatnonzero(in_radius)
        T_inv = np.linalg.inv(_rm_roll_pitch(run.odom[k]))
        local = run.centers[members] @ T_inv[:3, :3].T + T_inv[:3, 3]
        order = sorted(range(len(members)), key=lambda q: abs(ref_time[members[q]] - t))
        keep = [members[q] for q in order[:cap]]
        kept_local = [local[q] for q in order[:cap]]
        if keep:
            out.append((keep, kept_local))
    S, D = len(out), run.desc.shape[1]
    sm = Submaps(centers=np.zeros((S, cap, 3), np.float32),
                 ratio=np.zeros((S, cap, 4), np.float32),
                 desc=np.zeros((S, cap, D), np.float32),
                 valid=np.zeros((S, cap), bool),
                 ids=np.full((S, cap), -1, np.int64))
    for s, (keep, local) in enumerate(out):
        n = len(keep)
        sm.centers[s, :n] = np.asarray(local)
        sm.ratio[s, :n, :3] = run.pca[keep]
        sm.ratio[s, :n, 3] = run.volume[keep]
        sm.desc[s, :n] = _unit(run.desc[keep])
        sm.valid[s, :n] = True
        sm.ids[s, :n] = keep
    return sm


def make_scene(config: dict) -> list:
    """Both robots' packed submaps of a configuration file's scene (its
    `scene` group, drawn from the scene's own seed) cut by its `align`
    group. A run's seed does not change the scene, only the order in
    which the traffic takes its pairs, so every seed gives the same work."""
    rng = np.random.default_rng(config["scene"]["seed"])
    return [make_submaps(r, config["align"]) for r in make_runs(rng, config["scene"])]


def full_grid(subs: list):
    """(pair_i, pair_j): every submap of robot 0 against every submap of
    robot 1, row by row."""
    pi, pj = np.meshgrid(np.arange(len(subs[0].valid)), np.arange(len(subs[1].valid)),
                         indexing="ij")
    return pi.reshape(-1), pj.reshape(-1)
