"""Offline RPGO params — parity with reference
roman/params/offline_rpgo_params.py:21-37 (host copy of
roman_tpu/params/offline_rpgo_params.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import yaml


@dataclasses.dataclass
class OfflineRPGOParams:
    odom_t_std: float = 0.1
    odom_r_std: float = float(np.deg2rad(0.5))
    lc_t_std: float = 1.0
    lc_r_std: float = float(np.deg2rad(2.0))
    sparsified: bool = True

    # solver knobs (the robust PGO replacing the RpgoReadG2o subprocess,
    # demo/demo.py:246-250); the PCM gate threshold lives in
    # rpgo.solver.RPGOSolverParams.pcm_thresh
    gnc_iters: int = 25
    gn_iters: int = 6
    pcm_gate: bool = True

    @classmethod
    def from_yaml(cls, yaml_file: str) -> "OfflineRPGOParams":
        with open(yaml_file) as f:
            params = yaml.full_load(f)
        return cls(**params)
