"""Synthetic RGB-D recordings as ROS1 bags, for driving the demo CLI's
recorded-data path ('type: bag' in data.yaml) without recorded data.

Each robot's bag holds what a recorded run holds: rgb8 color frames and
16UC1 depth frames (millimetres), a CameraInfo, nav_msgs/Odometry of the
base, and the base -> camera extrinsic on /tf_static. The robot drives
along x at `speed` with odometry drift growing as the square of the
distance; the depth image shows two near boxes in front of a far wall.
The params directory that goes with the bags uses the ${ROBOT} run-env
indirection and takes the pose stream's extrinsic from the bag's TF
(T_postmultiply with input_type tf).
"""

from __future__ import annotations

import os

import numpy as np
import yaml

from roman_tpu_torch.data import rosbag

T_BASE_CAMERA_XYZ = (0.05, 0.0, 0.1)


def write_robot_bag(path: str, rng, frames: int, height: int, width: int,
                    dt: float, x0: float = 0.0, speed: float = 0.5,
                    drift: float = 0.002):
    """Write one robot's bag; returns (gt rows [t x y z qx qy qz qw], (T,
    4, 4) odometry poses of the base)."""
    H, W = height, width
    K = np.array([[100.0 * W / 128, 0, W / 2], [0, 100.0 * W / 128, H / 2], [0, 0, 1]])
    gt_rows, odom_x = [], []
    near = np.full((H, W), 4.0, np.float32)
    near[20 * H // 96:60 * H // 96, 30 * W // 128:70 * W // 128] = 1.5
    near[65 * H // 96:90 * H // 96, 80 * W // 128:115 * W // 128] = 2.5
    depth_mm = (near * 1000).astype(np.uint16).tobytes()
    with rosbag.BagWriter(path) as w:
        w.write("/tf_static", "tf2_msgs/TFMessage", {"transforms": [{
            "header": {"stamp": 0.0, "frame_id": "base"},
            "child_frame_id": "camera",
            "transform": {"translation": np.array(T_BASE_CAMERA_XYZ),
                          "rotation": np.array([0.0, 0, 0, 1.0])},
        }]}, 0.0)
        w.write("/camera/camera_info", "sensor_msgs/CameraInfo", {
            "header": {"stamp": 0.0, "frame_id": "camera"},
            "height": H, "width": W,
            "distortion_model": "plumb_bob", "D": np.zeros(5),
            "K": K.reshape(-1), "R": np.eye(3).reshape(-1),
            "P": np.concatenate([K, np.zeros((3, 1))], 1).reshape(-1),
        }, 0.0)
        for k in range(frames):
            t = k * dt
            x_gt = x0 + speed * t
            x_od = x_gt + drift * x_gt * x_gt
            gt_rows.append([t, x_gt, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
            odom_x.append(x_od)
            w.write("/odom", "nav_msgs/Odometry", {
                "header": {"stamp": t, "frame_id": "odom"},
                "child_frame_id": "base",
                "pose": {"position": np.array([x_od, 0.0, 0.0]),
                         "orientation": np.array([0.0, 0, 0, 1.0])},
            }, t)
            img = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
            w.write("/camera/color", "sensor_msgs/Image", {
                "header": {"stamp": t, "frame_id": "camera"},
                "height": H, "width": W, "encoding": "rgb8",
                "is_bigendian": 0, "step": W * 3, "data": img.tobytes(),
            }, t)
            w.write("/camera/depth", "sensor_msgs/Image", {
                "header": {"stamp": t, "frame_id": "camera"},
                "height": H, "width": W, "encoding": "16UC1",
                "is_bigendian": 0, "step": W * 2, "data": depth_mm,
            }, t)
    odom = np.broadcast_to(np.eye(4), (frames, 4, 4)).copy()
    odom[:, 0, 3] = odom_x
    return np.asarray(gt_rows), odom


def write_bag_world(root: str, runs, frames: int, height: int, width: int,
                    dt: float, seed: int, fastsam: dict, mapper: dict,
                    submap_align: dict):
    """Bags, ground truth csv files and a params directory for `runs`
    under root: root/<run>.bag, root/gt_<run>.csv, root/params/{data,
    gt_pose,fastsam,mapper,submap_align}.yaml. Returns (params dir,
    {run: odometry poses}, the base -> camera extrinsic)."""
    rng = np.random.default_rng(seed)
    odoms = {}
    for i, run in enumerate(runs):
        gt_rows, odoms[run] = write_robot_bag(
            os.path.join(root, f"{run}.bag"), rng, frames, height, width, dt,
            x0=0.5 * i)
        np.savetxt(os.path.join(root, f"gt_{run}.csv"), gt_rows)
    params = os.path.join(root, "params")
    os.makedirs(params, exist_ok=True)
    bag = os.path.join(root, "${ROBOT}.bag")
    files = {
        "data": {"runs": list(runs), "run_env": "ROBOT", "dt": dt,
                 "img_data": {"type": "bag", "path": bag, "topic": "/camera/color",
                              "depth_topic": "/camera/depth",
                              "camera_info_topic": "/camera/camera_info",
                              "depth_scale": 1000.0},
                 "pose_data": {"type": "bag", "path": bag, "topic": "/odom",
                               "T_postmultiply": {"input_type": "tf", "parent": "base",
                                                  "child": "camera"}}},
        "gt_pose": {"type": "csv", "path": os.path.join(root, "gt_${ROBOT}.csv")},
        "fastsam": fastsam, "mapper": mapper, "submap_align": submap_align}
    for name, spec in files.items():
        with open(os.path.join(params, f"{name}.yaml"), "w") as f:
            yaml.dump(spec, f)
    T_base_camera = np.eye(4)
    T_base_camera[:3, 3] = T_BASE_CAMERA_XYZ
    return params, odoms, T_base_camera
