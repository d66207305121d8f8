"""Mapping runner: the frame loop that feeds a mapper, on the host or on
the device backend.

Port of roman_tpu/map/run.py (reference ROMANMapRunner,
roman/map/run.py:44-198). ``mapper_params.mapper_backend`` picks the host
Mapper or the device BatchMapper; the device mapper runs on ``device``
(None means ``cuda``, and a host without a card raises unless the caller
passes ``device="cpu"``). ``run`` maps RGB-D frames through a perception
front end: the one passed as ``frontend``, or else the port's
``PerceptionFrontend`` built from ``fastsam_params`` on ``device``.
``run_observations`` maps a prebuilt observation stream with either
backend.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.map.mapper import Mapper
from roman_tpu_torch.map.roman_map import RomanMap
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.params.mapper_params import MapperParams


@dataclasses.dataclass
class ProcessingTimes:
    fastsam_times: List[float] = dataclasses.field(default_factory=list)
    map_times: List[float] = dataclasses.field(default_factory=list)
    total_times: List[float] = dataclasses.field(default_factory=list)


class MapRunner:
    """Drives mapping over a frame source or an observation stream."""

    def __init__(
        self,
        mapper_params: MapperParams,
        fastsam_params: FastSAMParams,
        camera: CameraParams,
        pose_data: PoseData,
        frontend=None,
        t0: Optional[float] = None,
        tf: Optional[float] = None,
        dt: float = 1.0 / 6.0,
        T_camera_flu=None,
        device=None,
    ):
        self.camera = camera
        self.pose_data = pose_data
        self.fastsam_params = fastsam_params
        self.mapper_params = mapper_params
        # camera->FLU convention of the OUTPUT trajectory only
        # (reference run.py:94-95)
        self.T_camera_flu = T_camera_flu
        self.device_mapper = mapper_params.mapper_backend == "device"
        # the front end that run() builds runs here (None means cuda)
        self.perception_device = device
        if self.device_mapper:
            self.device = resolve_device(device)
            # made once the descriptor width is known
            self.mapper = None
        else:
            self.device = None
            self.mapper = Mapper(mapper_params, camera)
            if T_camera_flu is not None:
                self.mapper.set_T_camera_flu(np.asarray(T_camera_flu))
        self.frontend = frontend
        self.dt = dt
        self.t0 = pose_data.t0 if t0 is None else t0
        self.tf = pose_data.tf if tf is None else tf
        self.times = ProcessingTimes()

    def frame_times(self) -> np.ndarray:
        return np.arange(self.t0, self.tf, self.dt)

    def _get_device_mapper(self, desc_dim: int):
        from roman_tpu_torch.map.batch_mapper import BatchMapper

        if self.mapper is None:
            self.mapper = BatchMapper(
                self.mapper_params, self.camera, desc_dim=desc_dim,
                obs_capacity=self.fastsam_params.max_masks_per_frame,
                device=self.device)
            if self.T_camera_flu is not None:
                self.mapper.set_T_camera_flu(np.asarray(self.T_camera_flu))
        else:
            # widen if the first batches had no descriptors
            self.mapper.ensure_desc_dim(desc_dim)
        return self.mapper

    def run(self, get_frames: Callable[[np.ndarray], tuple],
            verbose: bool = False) -> RomanMap:
        """get_frames(times) -> (images, depths) for the requested times,
        through the perception front end (built on first use when none was
        passed)."""
        from roman_tpu_torch.perception.wrapper import PerceptionFrontend

        if self.frontend is None:
            self.frontend = PerceptionFrontend(self.fastsam_params, self.camera,
                                               device=self.perception_device)
        B = self.fastsam_params.batch_frames
        all_times = self.frame_times()
        for s in range(0, len(all_times), B):
            ts = all_times[s: s + B]
            t_start = time.time()
            images, depths = get_frames(ts)
            poses = [self.pose_data.pose(float(t)) for t in ts]
            out = self.frontend.run_batch(images, depths)
            t_percep = time.time()
            if self.device_mapper:
                mapper = self._get_device_mapper(out.embeddings.shape[-1])
                val = out.points_valid & out.valid[..., None]
                mapper.update_batch(
                    ts, np.stack(poses), out.points, val, out.embeddings,
                    out.valid & val.any(-1),
                    frame_descriptors=out.frame_descriptors)
            else:
                obs_lists = self.frontend.observations(out, ts, poses)
                for t, pose, obs, fd in zip(ts, poses, obs_lists,
                                            out.frame_descriptors):
                    self.mapper.update(float(t), np.asarray(pose), obs, fd)
            t_map = time.time()
            n = len(ts)
            self.times.fastsam_times += [(t_percep - t_start) / n] * n
            self.times.map_times += [(t_map - t_percep) / n] * n
            self.times.total_times += [(t_map - t_start) / n] * n
            if verbose:
                print(f"mapping t={ts[-1]:.1f}/{self.tf:.1f}")
        return self.mapper.get_roman_map()

    def run_observations(self, observation_source, verbose: bool = False) -> RomanMap:
        """Map a prebuilt stream: observation_source(t) -> (pose,
        [Observation], frame_descriptor)."""
        if self.device_mapper:
            return self._run_observations_device(observation_source)
        for t in self.frame_times():
            t_start = time.time()
            pose, obs, fd = observation_source(float(t))
            t_percep = time.time()
            self.mapper.update(float(t), pose, obs, fd)
            t_end = time.time()
            self.times.fastsam_times.append(t_percep - t_start)
            self.times.map_times.append(t_end - t_percep)
            self.times.total_times.append(t_end - t_start)
        return self.mapper.get_roman_map()

    def _run_observations_device(self, observation_source) -> RomanMap:
        """The stream on the device mapper: frames are packed on the host
        and sent in batches of batch_frames."""
        B = max(self.fastsam_params.batch_frames, 1)
        all_times = self.frame_times()
        for s in range(0, len(all_times), B):
            ts = all_times[s: s + B]
            t_start = time.time()
            frames = [observation_source(float(t)) for t in ts]
            desc_dim = None
            for _, obs, _ in frames:
                for o in obs:
                    if o.semantic_descriptor is not None:
                        desc_dim = np.asarray(o.semantic_descriptor).size
                        break
                if desc_dim:
                    break
            mapper = self._get_device_mapper(desc_dim or 8)
            packed = [mapper.pack_observations(obs) for _, obs, _ in frames]
            pts = np.stack([p[0] for p in packed])
            val = np.stack([p[1] for p in packed])
            desc = np.stack([p[2] for p in packed])
            mask = np.stack([p[3] for p in packed])
            poses = np.stack([f[0] for f in frames])
            fds = [f[2] for f in frames]
            t_percep = time.time()
            mapper.update_batch(
                ts, poses, pts, val, desc, mask,
                frame_descriptors=fds if fds[0] is not None else None)
            t_end = time.time()
            n = len(ts)
            self.times.fastsam_times += [(t_percep - t_start) / n] * n
            self.times.map_times += [(t_end - t_percep) / n] * n
            self.times.total_times += [(t_end - t_start) / n] * n
        return self.mapper.get_roman_map()
