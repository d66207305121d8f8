"""Time-indexed pose sequences with interpolation (host copy of
roman_tpu/data/pose_data.py).

Standalone replacement for the robotdatapy.data.pose_data.PoseData
dependency of the reference (used for GT poses in submap_align.py:41-58,
LC retiming in combine_loop_closures.py:176-183, and g2o export in
results.py:154). Supports array, csv (TUM: t x y z qx qy qz qw), bag and
yaml-spec construction; pose(t) interpolates (lerp + slerp) between the
bracketing samples like robotdatapy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from roman_tpu_torch.ops import se3_np


@dataclasses.dataclass
class PoseData:
    times: np.ndarray          # (T,) seconds, strictly increasing
    poses: np.ndarray          # (T, 4, 4)
    interp: bool = True
    time_tol: float = 1.0      # max extrapolation distance in seconds
    t0_shift: float = 0.0

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=np.float64)
        self.poses = np.asarray(self.poses, dtype=np.float64)
        order = np.argsort(self.times)
        self.times = self.times[order]
        self.poses = self.poses[order]

    @classmethod
    def from_times_and_poses(cls, times, poses, **kw):
        return cls(times=np.asarray(times), poses=np.asarray(poses), **kw)

    @classmethod
    def from_csv(cls, path, time_col=0, cols="xyzqxyzw", delimiter=None, skiprows=0, **kw):
        """TUM-style csv/txt: t x y z qx qy qz qw (whitespace or comma)."""
        data = np.loadtxt(path, delimiter=delimiter, skiprows=skiprows, comments="#")
        t = data[:, time_col]
        xyz = data[:, 1:4]
        quat = data[:, 4:8]
        T = se3_np.xyz_quat_to_T(xyz, quat)
        return cls(times=t, poses=T, **kw)

    @classmethod
    def from_bag(cls, path, topic, **kw):
        """Pose stream from a ROS1 bag or rosbag2 topic (Odometry /
        PoseStamped / PoseWithCovarianceStamped / TransformStamped /
        TFMessage), via the pure-python reader in
        roman_tpu_torch.data.rosbag (reference reads bags through
        robotdatapy, data_params.py:200-294)."""
        from roman_tpu_torch.data import rosbag

        times, T = rosbag.read_poses(path, topic)
        return cls(times=times, poses=T, **kw)

    @classmethod
    def from_csv_options(cls, path, csv_options: dict, **kw):
        """Reference gt_pose.yaml csv schema (robotdatapy csv options,
        reference params/demo/gt_pose.yaml): explicit column numbers for
        time / position / orientation(qx qy qz qw) plus a timescale."""
        cn = csv_options.get("col_nums", {})
        tcol = cn.get("time", [0])[0]
        pcols = cn.get("position", [1, 2, 3])
        qcols = cn.get("orientation", [4, 5, 6, 7])
        ts = float(csv_options.get("timescale", 1.0))
        with open(path) as f:
            first = f.readline()
        delim = "," if "," in first else None
        skip = 0
        names = csv_options.get("cols")
        if names:
            # header-name columns (robotdatapy 'cols' schema, reference
            # params/kimera_multi_data/gt_pose.yaml); falls back to
            # col_nums when the named columns aren't in the header
            header = [h.strip() for h in first.strip().split("," if delim else None)]
            idx = {h: i for i, h in enumerate(header)}
            wanted = (list(names.get("time", [])) + list(names.get("position", []))
                      + list(names.get("orientation", [])))
            # use names only when every referenced column exists in the
            # header (and all three groups are named) — else col_nums
            if (names.get("time") and names.get("position")
                    and names.get("orientation")
                    and all(c in idx for c in wanted)):
                tcol = idx[names["time"][0]]
                pcols = [idx[c] for c in names["position"]]
                qcols = [idx[c] for c in names["orientation"]]
                skip = 1
            elif first.strip() and not first.lstrip().startswith("#"):
                # named columns requested but not all present: still skip
                # a non-numeric header line so np.loadtxt doesn't crash
                # on it in the col_nums fallback
                try:
                    float(first.strip().split("," if delim else None)[0])
                except ValueError:
                    skip = 1
        data = np.loadtxt(path, delimiter=delim, comments=None if skip else "#",
                          skiprows=skip)
        t = data[:, tcol] * ts
        T = se3_np.xyz_quat_to_T(data[:, pcols], data[:, qcols])
        return cls(times=t, poses=T, **kw)

    @classmethod
    def from_yaml_spec(cls, spec: dict, **kw):
        """Pose data from a yaml dict like the reference's GT pose yaml
        (submap_align.py:49-58). Supported types: 'csv' (with optional
        robotdatapy-style csv_options), 'bag'."""
        from roman_tpu_torch.utils import expandvars_recursive

        kind = spec.get("type", "csv")
        path = expandvars_recursive(spec["path"])
        for opt in ("interp", "time_tol", "t0_shift"):
            if opt in spec and opt not in kw:
                kw[opt] = spec[opt]
        if kind == "csv":
            if "csv_options" in spec:
                return cls.from_csv_options(path, spec["csv_options"], **kw)
            for opt in ("time_col", "delimiter", "skiprows"):
                if opt in spec:
                    kw[opt] = spec[opt]
            return cls.from_csv(path, **kw)
        if kind == "bag":
            return cls.from_bag(path, expandvars_recursive(spec["topic"]),
                                **kw)
        raise ValueError(f"unsupported pose data type {kind!r}")

    def nearest_time(self, t: float) -> float:
        return float(self.times[self.idx(t)])

    def idx(self, t: float, force_single: bool = True) -> int:
        """Index of the sample nearest to t (reference PoseData.idx usage,
        results.py:182-183)."""
        return int(np.argmin(np.abs(self.times - (t + self.t0_shift))))

    def pose(self, t):
        """Interpolated pose at time t (scalar or array)."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64)) + self.t0_shift
        ts = self.times
        i1 = np.clip(np.searchsorted(ts, t), 1, len(ts) - 1)
        i0 = i1 - 1
        denom = np.maximum(ts[i1] - ts[i0], 1e-12)
        alpha = np.clip((t - ts[i0]) / denom, 0.0, 1.0)
        if not self.interp:
            alpha = np.round(alpha)
        out = se3_np.interp_T(self.poses[i0], self.poses[i1], alpha)
        # tolerance check
        nearest = np.minimum(np.abs(ts[i0] - t), np.abs(ts[i1] - t))
        if np.any(nearest > self.time_tol):
            bad = float(np.max(nearest))
            raise ValueError(f"pose query {bad:.3f}s outside data (tol {self.time_tol}s)")
        return out[0] if out.shape[0] == 1 and np.isscalar(t) is False and t.shape == (1,) else out

    @property
    def t0(self):
        return float(self.times[0])

    @property
    def tf(self):
        return float(self.times[-1])

    def positions(self):
        return self.poses[:, :3, 3]
