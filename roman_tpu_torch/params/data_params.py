"""Data-loading params (host copy of roman_tpu/params/data_params.py) —
schema parity with reference roman/params/data_params.py. Supported input
types: ROS1 bags / rosbag2 (pure-python parsers,
roman_tpu_torch.data.rosbag[2]), image directories /
zips / npz archives for RGB-D, csv for poses; both the reference's yaml
key spellings (img_data/depth_data/pose_data/time) and the *_params
forms are accepted; the run-env indirection (one yaml serving N robots,
reference demo/README.md:151-169), recursive env expansion, per-run
dict override merge (data_params.py:177-194), and pose frame
post-multiply (T_camera_flu/T_odombase_camera) are preserved."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import yaml

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.utils import combinedicts_recursive, expandvars_recursive

# FLU <-> RDF camera/body frame conventions (robotdatapy T_FLURDF/T_RDFFLU)
T_FLURDF = np.array(
    [[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0], [0, 0, 0, 1]]
)
T_RDFFLU = np.linalg.inv(T_FLURDF)


def find_transformation(param_dict: dict,
                        bag_path: Optional[str] = None) -> np.ndarray:
    """Transform spec resolution (reference data_params.py:25-62):
    'string', 'matrix', or 'tf' input types. 'tf' looks the (parent,
    child) transform up in the run's bag TF tree (chained static lookup,
    rosbag.read_static_transform — robotdatapy any_static_tf_from_bag
    semantics; include_non_static_tf admits /tf edges at their first
    published value). The bag defaults to the enclosing source's path;
    an explicit 'path' key overrides it."""
    kind = param_dict["input_type"]
    if kind == "string":
        if param_dict["string"] == "T_FLURDF":
            return T_FLURDF
        if param_dict["string"] == "T_RDFFLU":
            return T_RDFFLU
        raise ValueError("Invalid string.")
    if kind == "matrix":
        return np.array(param_dict["matrix"]).reshape(4, 4)
    if kind == "tf":
        from roman_tpu_torch.data import rosbag

        path = param_dict.get("path", bag_path)
        if path is None:
            raise ValueError("input_type 'tf' needs a bag source "
                             "('path' key or an enclosing bag params)")
        return rosbag.read_static_transform(
            expandvars_recursive(path),
            expandvars_recursive(param_dict["parent"]),
            expandvars_recursive(param_dict["child"]),
            include_non_static=param_dict.get("include_non_static_tf",
                                              False))
    raise ValueError(f"unsupported transformation input_type {kind!r}")


@dataclasses.dataclass
class DataParams:
    runs: List[str] = dataclasses.field(default_factory=lambda: ["run0"])
    run_env: Optional[str] = None
    time_params: Optional[dict] = None
    img_data_params: Optional[dict] = None
    depth_data_params: Optional[dict] = None
    pose_data_params: Optional[dict] = None
    pointcloud_data_params: Optional[dict] = None
    dt: float = 1.0 / 6.0

    # the reference's data.yaml spells these without the _params suffix
    # (reference data_params.py:182-191: img_data / depth_data /
    # pose_data / time); both spellings are accepted
    _KEY_ALIASES = {"img_data": "img_data_params",
                    "depth_data": "depth_data_params",
                    "pose_data": "pose_data_params",
                    "pointcloud_data": "pointcloud_data_params",
                    "time": "time_params"}

    @classmethod
    def from_yaml(cls, yaml_path: str, run: Optional[str] = None) -> "DataParams":
        with open(os.path.expanduser(yaml_path)) as f:
            data = yaml.safe_load(f)
        base = {k: v for k, v in data.items() if k not in data.get("runs", [])}
        if run is not None and isinstance(data.get(run), dict):
            base = combinedicts_recursive(base, data[run])
        base.pop(run, None)
        base = {cls._KEY_ALIASES.get(k, k): v for k, v in base.items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in base.items() if k in known})

    def set_run_env(self, run: str):
        if self.run_env is not None:
            os.environ[self.run_env] = run

    def load_pose_data(self) -> PoseData:
        p = dict(self.pose_data_params or {})
        path = expandvars_recursive(p.pop("path"))
        kind = p.pop("type", "csv")
        # frame-convention post-multiply: ONLY T_postmultiply /
        # T_odombase_camera bake into the loaded poses, which must remain
        # T_odom_camera (reference data_params.py:200-212). T_camera_flu
        # is NOT composed here — the reference hands it to the mapper
        # (Mapper.set_T_camera_flu, run.py:94-95) which uses it solely to
        # express the OUTPUT trajectory in the FLU body frame, while
        # observation lifting keeps camera-frame poses.
        T_post = None
        for key in ("T_postmultiply", "T_odombase_camera"):
            if p.get(key) is not None:
                T_post = find_transformation(
                    p.pop(key), bag_path=path if kind == "bag" else None)
                break
        p.pop("T_camera_flu", None)
        # delegate source dispatch to the shared spec loader so csv
        # sources honor csv_options (robotdatapy col_nums/cols/timescale
        # schemas) exactly like standalone gt_pose yamls do — a parallel
        # from_csv call here silently mis-parsed EuRoC-layout csvs
        p["type"] = kind
        p["path"] = path
        pd = PoseData.from_yaml_spec(p)
        if T_post is not None:
            pd.poses = pd.poses @ T_post
        return pd

    @property
    def T_camera_flu(self):
        """(4, 4) camera->FLU convention matrix from pose_data, or None —
        consumed by the mapper for FLU trajectory output (reference
        PoseDataParams.T_camera_flu + Mapper.set_T_camera_flu)."""
        p = self.pose_data_params or {}
        spec = p.get("T_camera_flu")
        if spec is None:
            return None
        bag = p.get("path") if p.get("type") == "bag" else None
        return find_transformation(
            spec, bag_path=expandvars_recursive(bag) if bag else None)

    def load_camera_params(self) -> CameraParams:
        p = self.img_data_params or {}
        if p.get("type") == "bag" and "camera_info_topic" in p:
            return CameraParams.from_bag(
                expandvars_recursive(p["path"]),
                expandvars_recursive(p["camera_info_topic"]))
        if "K" in p:
            K = np.array(p["K"]).reshape(3, 3)
            return CameraParams(K=K, width=p.get("width", 640), height=p.get("height", 480))
        return CameraParams.simple(p.get("width", 640), p.get("height", 480))

    def load_pointcloud_data(self):
        """(times, list of (N_i, 3) xyz clouds) from the pointcloud_data
        bag source (reference load_pointcloud_data, data_params.py:214-230;
        feeds the AlignPointCloud LiDAR path)."""
        p = self.pointcloud_data_params or {}
        if p.get("type", "bag") != "bag":
            raise ValueError("pointcloud_data supports bag sources only")
        from roman_tpu_torch.data import rosbag

        return rosbag.read_pointclouds(expandvars_recursive(p["path"]),
                                       expandvars_recursive(p["topic"]))
