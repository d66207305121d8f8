"""Submap alignment params: the yaml schema of roman_tpu (and of the
reference roman/params/submap_align_params.py:26-150), with the method
factory that maps method names to a RegistrationConfig."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Union

import numpy as np
import yaml

from roman_tpu_torch.align.registration import RegistrationConfig


@dataclasses.dataclass
class SubmapAlignParams:
    dim: int = 3
    method: str = "roman"
    fusion_method: str = "geometric_mean"

    force_fill_submaps: bool = False
    submap_max_size: int = 40
    submap_overlap: int = 20
    submap_radius: Optional[float] = 15.0
    submap_center_dist: float = 10.0
    submap_center_time: float = 50.0
    submap_pruning_method: str = "distance"
    submap_descriptor: Union[str, None] = None
    frame_descriptor_dist: Optional[float] = None
    submap_descriptor_thresh: float = 0.8

    single_robot_lc: bool = False
    single_robot_lc_time_thresh: float = 50.0
    force_rm_lc_roll_pitch: bool = True
    force_rm_upside_down: bool = True
    use_object_bottom_middle: bool = False

    sigma: float = 0.4
    epsilon: float = 0.6
    mindist: float = 0.2
    epsilon_shape: float = 0.0
    ransac_iter: int = 4096
    cosine_min: float = 0.5
    cosine_max: float = 0.7
    semantics_dim: int = 768
    gravity_unc_ang_rad: float = 0.0872665

    # knobs of the TPU engine: still parsed so that the same yaml files
    # load, and without effect here (the device of the tensors decides
    # between a kernel and its plain twin)
    use_pallas: Optional[bool] = None
    pallas_pairs_per_step: int = 4
    per_pair_timing: bool = False  # chunk-timed dispatch for timing_list
    # multi-restart homotopy (ClipperSolveParams.n_restarts): R perturbed
    # starts per pair ride the same per-pair MXU matvec; best feasible
    # omega wins. 1 = single-start (reference-equivalent trajectory).
    solver_restarts: int = 1

    def __post_init__(self):
        if isinstance(self.submap_descriptor, str) and self.submap_descriptor.lower() == "none":
            self.submap_descriptor = None

    @classmethod
    def from_yaml(cls, yaml_file: str) -> "SubmapAlignParams":
        with open(yaml_file) as f:
            params = yaml.full_load(f)
        return cls(**params)

    def get_registration_config(self) -> RegistrationConfig:
        """Method factory (reference submap_align_params.py:86-150)."""
        from roman_tpu_torch.align.clipper import ClipperSolveParams

        return RegistrationConfig(
            solver=ClipperSolveParams(n_restarts=self.solver_restarts),
            method=self.method,
            dim=self.dim,
            fusion=self.fusion_method,
            sigma=self.sigma,
            epsilon=self.epsilon,
            mindist=self.mindist,
            epsilon_shape=self.epsilon_shape,
            cos_min=self.cosine_min,
            cos_max=self.cosine_max,
            gravity_unc_ang_rad=self.gravity_unc_ang_rad,
            ransac_iter=self.ransac_iter,
        )


@dataclasses.dataclass
class SubmapAlignInputOutput:
    """Parity with reference SubmapAlignInputOutput
    (submap_align_params.py:153-199)."""

    inputs: List[str]
    output_dir: str
    run_name: str
    input_type_pkl: bool = True
    input_type_json: bool = False
    input_gt_pose_yaml: List[Optional[str]] = dataclasses.field(
        default_factory=lambda: [None, None]
    )
    robot_names: List[str] = dataclasses.field(default_factory=lambda: ["0", "1"])
    robot_env: Optional[str] = None
    lc_association_thresh: int = 4
    g2o_t_std: float = 0.5
    g2o_r_std: float = float(np.deg2rad(0.5))
    debug_show_maps: bool = False
    skip_distance: float = float("inf")

    def _p(self, suffix: str) -> str:
        return os.path.join(self.output_dir, f"{self.run_name}{suffix}")

    @property
    def output_img(self):
        return self._p(".png")

    @property
    def output_matrix(self):
        return self._p(".matrix.pkl")

    @property
    def output_pkl(self):
        return self._p(".pkl")

    @property
    def output_timing(self):
        return self._p(".timing.txt")

    @property
    def output_params(self):
        return self._p(".params.txt")

    @property
    def output_g2o(self):
        return self._p(".g2o")

    @property
    def output_lc_json(self):
        return self._p(".json")

    @property
    def output_submaps(self):
        return [os.path.join(self.output_dir, f"{rn}.sm.json") for rn in self.robot_names]
