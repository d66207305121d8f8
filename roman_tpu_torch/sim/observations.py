"""Synthetic observation streams for the mapping stage.

- sim_observation_source: a simulated robot ('type: sim' data), the world
  of sim.world replayed as per-frame object observations; a copy of
  demo/mapping.py:34-82 on the port's sim.world, so the mapping stage runs
  without the JAX package;
- mapping_bench_stream: the stream of bench.py's mapping benchmark.
"""

from __future__ import annotations

import numpy as np

from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.map.observation import Observation
from roman_tpu_torch.sim import world as sim_world


def sim_observation_source(img_data_params: dict, runs, run_name: str):
    """img_data_params: the img_data_params block of a sim data.yaml (seed,
    n_robots, n_objects, area, traj_len, desc_dim); runs: the run names;
    run_name: the robot to replay.

    Returns (source, pose_data, gt_pose_data, robot): source(t) -> (odometry
    pose, [Observation], frame descriptor), with each object within 12 m
    of the robot and inside its seen-time window observed as 40 points
    around its center."""
    spec = img_data_params or {}
    seed = int(spec.get("seed", 0))
    n_robots = int(spec.get("n_robots", len(runs)))
    rng = np.random.default_rng(seed)
    _, robots = sim_world.make_multi_robot_world(
        rng,
        n_robots=n_robots,
        n_objects=int(spec.get("n_objects", 600)),
        area=tuple(spec.get("area", (100.0, 100.0, 4.0))),
        traj_len=float(spec.get("traj_len", 150.0)),
        desc_dim=int(spec.get("desc_dim", 64)),
    )
    ridx = list(runs).index(run_name)
    robot = robots[ridx]
    obs_rng = np.random.default_rng(seed + 100 + ridx)

    pose_data = PoseData.from_times_and_poses(robot.times, robot.odom_poses)
    gt_pose_data = PoseData.from_times_and_poses(robot.times, robot.poses)

    def source(t: float):
        k = int(np.argmin(np.abs(robot.times - t)))
        pose = robot.odom_poses[k]
        obs = []
        for si in range(len(robot.seg_centers)):
            if not (robot.seg_first_seen[si] <= t <= robot.seg_last_seen[si]):
                continue
            c = robot.seg_centers[si]
            if np.linalg.norm(c[:2] - pose[:2, 3]) > 12.0:
                continue
            pts_w = c + obs_rng.normal(size=(40, 3)) * np.maximum(
                robot.seg_extent[si] / 4.0, 0.05)
            Ti = np.linalg.inv(pose)
            obs.append(Observation(time=t, pose=pose,
                                   point_cloud=pts_w @ Ti[:3, :3].T + Ti[:3, 3],
                                   semantic_descriptor=robot.seg_desc[si]))
        fd = np.ones(8, np.float32)
        return pose, obs, fd

    return source, pose_data, gt_pose_data, robot


def mapping_bench_stream(n_frames=64, obs_per_frame=24, pts_per_obs=128,
                         desc_dim=64, seed=0, n_objects=150, length=120.0,
                         speed=1.5):
    """The observation stream of bench.py's mapping benchmark
    (bench.py:455-480), the same numpy recipe: n_objects objects along x
    (spread over `length` m), a robot at `speed` m/s observing each object
    within 8 m as pts_per_obs points of std 0.2 m around its center, in
    the camera frame.

    Returns (times (B,), poses (B, 4, 4), points (B, O, Q, 3) f32,
    points_valid (B, O, Q), descriptors (B, O, D) f32, obs_mask (B, O))."""
    rng = np.random.default_rng(seed)
    O, Q = obs_per_frame, pts_per_obs
    centers = np.stack([
        np.linspace(0.0, length, n_objects),
        rng.uniform(-6, 6, n_objects),
        rng.uniform(0, 2, n_objects),
    ], axis=1)
    descs = rng.normal(size=(n_objects, desc_dim)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)

    times = np.arange(n_frames) * (1.0 / 6.0)
    poses = np.broadcast_to(np.eye(4), (n_frames, 4, 4)).copy()
    poses[:, 0, 3] = times * speed
    pts = np.zeros((n_frames, O, Q, 3), np.float32)
    val = np.zeros((n_frames, O, Q), bool)
    desc = np.zeros((n_frames, O, desc_dim), np.float32)
    mask = np.zeros((n_frames, O), bool)
    for f in range(n_frames):
        near = np.flatnonzero(np.abs(centers[:, 0] - poses[f, 0, 3]) < 8.0)[:O]
        Ti = np.linalg.inv(poses[f])
        for k, i in enumerate(near):
            pw = centers[i] + rng.normal(size=(Q, 3)).astype(np.float32) * 0.2
            pts[f, k] = pw @ Ti[:3, :3].T + Ti[:3, 3]
            val[f, k] = True
            desc[f, k] = descs[i]
            mask[f, k] = True
    return times, poses, pts, val, desc, mask


def stream_observations(times, poses, pts, val, desc, mask):
    """The frames of a packed stream as Observation lists, as bench.py
    feeds the host Mapper (bench.py:522-527)."""
    frames = []
    for f in range(len(times)):
        frames.append([Observation(time=float(times[f]), pose=poses[f],
                                   point_cloud=pts[f, k][val[f, k]],
                                   semantic_descriptor=desc[f, k])
                       for k in range(mask.shape[1]) if mask[f, k]])
    return frames
