"""Mapping stage driver of the demo CLI: per-run mapping with optional time
chunking and map concatenation (port of demo/mapping.py; reference
demo/mapping.py:61-244: run(), mapping(), <run>.time.txt output).

Data ingestion covers every data.yaml type: synthetic worlds ('type:
sim', replayed by roman_tpu_torch.sim.observations), npz archives, image
directories and zips, and ROS1 bags or rosbag2 recordings. The mapper and
the perception front end run on ``device`` (None means cuda).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from roman_tpu_torch.map.roman_map import RomanMap
from roman_tpu_torch.map.run import MapRunner
from roman_tpu_torch.params.data_params import DataParams
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.params.mapper_params import MapperParams


@dataclasses.dataclass
class VisualizationParams:
    viz_map: bool = False
    viz_observations: bool = False
    viz_3d: bool = False
    vid_rate: float = 1.0
    save_img_data: bool = False


def _load_img_data(data_params: DataParams):
    """The run's RGB-D frames (ImgData) from its img_data (and depth_data)
    source."""
    from roman_tpu_torch.data import rosbag
    from roman_tpu_torch.data.img_data import ImgData
    from roman_tpu_torch.utils import expandvars_recursive as _exp

    spec = data_params.img_data_params
    data_type = spec["type"]
    if data_type == "npz":
        # archive with images (T,H,W,3), depths (T,H,W), times (T,)
        return ImgData.from_npz(os.path.expanduser(spec["path"]),
                                depth_scale=spec.get("depth_scale", 1.0))
    if data_type == "dir":
        return ImgData.from_dir(spec["path"],
                                depth_scale=spec.get("depth_scale", 1000.0))
    if data_type == "zip":
        return ImgData.from_zip(spec["path"],
                                depth_scale=spec.get("depth_scale", 1000.0))
    # bag: depth may live on a topic in the same bag (depth_topic) or in a
    # separate depth_data source (reference data.yaml schema: img_data +
    # depth_data blocks)
    dspec = data_params.depth_data_params or {}
    img_data = ImgData.from_bag(
        os.path.expanduser(_exp(spec["path"])), _exp(spec["topic"]),
        depth_topic=spec.get("depth_topic"),
        depth_scale=spec.get("depth_scale", 1000.0))
    if img_data.depths is None and dspec.get("type") == "bag":
        dt_, darr = rosbag.read_images(os.path.expanduser(_exp(dspec["path"])),
                                       _exp(dspec["topic"]))
        if darr.dtype != np.float32:  # 16UC1 mm -> meters, as numpy divides
            darr = darr.astype(np.float32) / dspec.get("depth_scale", 1000.0)
        idx = np.argmin(np.abs(dt_[None, :] - img_data.times[:, None]), axis=1)
        img_data.depths = darr[idx]
    return img_data


def run(params_path: str, run_name: str, max_time: Optional[float] = None,
        t_offset: float = 0.0, verbose: bool = False, device=None) -> tuple:
    """One mapping run (reference demo/mapping.py:61-150): (map, the
    runner's ProcessingTimes, ground-truth PoseData of a sim run or
    None)."""
    data_params = DataParams.from_yaml(os.path.join(params_path, "data.yaml"), run_name)
    data_params.set_run_env(run_name)
    mapper_yaml = os.path.join(params_path, "mapper.yaml")
    mapper_params = (MapperParams.from_yaml(mapper_yaml, run_name)
                     if os.path.exists(mapper_yaml) else MapperParams())
    fastsam_yaml = os.path.join(params_path, "fastsam.yaml")
    fastsam_params = (FastSAMParams.from_yaml(fastsam_yaml, run_name)
                      if os.path.exists(fastsam_yaml) else FastSAMParams())

    def clip_time(t0, tf, data_t0):
        """Apply the data.yaml time block (reference data_params.py:
        149-152: {relative, t0, tf} clips the run window)."""
        tp = data_params.time_params
        if not tp:
            return t0, tf
        base = data_t0 if tp.get("relative", True) else 0.0
        return max(t0, base + tp["t0"]), min(tf, base + tp["tf"])

    data_type = (data_params.img_data_params or {}).get("type", "sim")
    if data_type == "sim":
        from roman_tpu_torch.sim.observations import sim_observation_source

        source, pose_data, gt_pose_data, _ = sim_observation_source(
            data_params.img_data_params, data_params.runs, run_name)
        camera = data_params.load_camera_params()
        t0 = pose_data.t0 + t_offset
        tf = pose_data.tf if max_time is None else min(pose_data.tf, t0 + max_time)
        t0, tf = clip_time(t0, tf, pose_data.t0)
        runner = MapRunner(mapper_params, fastsam_params, camera, pose_data,
                           t0=t0, tf=tf, dt=data_params.dt, device=device)
        roman_map = runner.run_observations(source, verbose=verbose)
        return roman_map, runner.times, gt_pose_data
    if data_type not in ("npz", "dir", "zip", "bag"):
        raise ValueError(f"unsupported data type {data_type!r}")
    img_data = _load_img_data(data_params)
    images, depths, times = img_data.images, img_data.depths, img_data.times
    pose_data = data_params.load_pose_data()
    camera = data_params.load_camera_params()
    t0 = max(times[0], pose_data.t0) + t_offset
    tf = min(times[-1], pose_data.tf)
    if max_time is not None:
        tf = min(tf, t0 + max_time)
    t0, tf = clip_time(t0, tf, max(times[0], pose_data.t0))
    runner = MapRunner(mapper_params, fastsam_params, camera, pose_data,
                       t0=t0, tf=tf, dt=data_params.dt,
                       T_camera_flu=data_params.T_camera_flu, device=device)

    scale = 255.0 if images.dtype == np.uint8 else 1.0

    def get_frames(ts):
        idx = np.argmin(np.abs(times[None, :] - np.asarray(ts)[:, None]), axis=1)
        return images[idx].astype(np.float32) / scale, depths[idx]

    roman_map = runner.run(get_frames, verbose=verbose)
    return roman_map, runner.times, None


def mapping(params_path: str, output_path: str, run_name: str,
            max_time: Optional[float] = None, viz_params=None,
            verbose: bool = False, gt_csv_path: Optional[str] = None,
            device=None):
    """Full mapping entry (reference demo/mapping.py:152-244): optional
    time-chunked runs merged via RomanMap.concatenate, pickle + time file
    output. For sim data, the ground-truth trajectory is exported to
    gt_csv_path (stands in for the recorded GT the reference reads from
    bags/csv)."""
    if max_time is None:
        roman_map, times, gt_pose_data = run(params_path, run_name, verbose=verbose,
                                             device=device)
        if gt_csv_path is not None and gt_pose_data is not None:
            from roman_tpu_torch.ops import se3_np

            t, q = se3_np.T_to_xyz_quat(gt_pose_data.poses)
            np.savetxt(gt_csv_path,
                       np.concatenate([gt_pose_data.times[:, None], t, q], axis=1))
    else:
        chunks = []
        times = None
        t_offset = 0.0
        while True:
            chunk, times, _ = run(params_path, run_name, max_time=max_time,
                                  t_offset=t_offset, verbose=verbose, device=device)
            if len(chunk.times) == 0:
                break
            chunks.append(chunk)
            t_offset += max_time
            if chunk.times[-1] >= chunk.times[0] and len(chunk.times) < 2:
                break
            # stop when the chunk did not fill the max_time window. A
            # FULL chunk spans max_time - dt (fencepost), so the bound
            # must be dt-aware
            dt_est = float(np.median(np.diff(chunk.times)))
            if (chunk.times[-1] - chunk.times[0]) < max_time - 2 * dt_est - 1e-9:
                break
        roman_map = RomanMap.concatenate(chunks)

    roman_map.save(output_path + ".pkl")
    if viz_params is not None and getattr(viz_params, "viz_3d", False):
        # third-person map-building video (reference viz.py:86-276)
        from roman_tpu_torch.viz import render_map_video

        vid = render_map_video(
            roman_map, output_path + ".mp4",
            fps=max(getattr(viz_params, "vid_rate", 1.0) * 6.0, 1.0))
        print(f"wrote 3D map video to {vid}")
    with open(output_path + ".time.txt", "w") as f:
        for name, vals in [("fastsam", times.fastsam_times),
                           ("map", times.map_times),
                           ("total", times.total_times)]:
            if vals:
                f.write(f"{name}: avg {np.mean(vals):.4f} s/frame, "
                        f"total {np.sum(vals):.2f} s\n")
    if verbose:
        print(f"saved map with {len(roman_map.segments)} segments to "
              f"{output_path}.pkl")
    return roman_map
