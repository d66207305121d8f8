"""Alias for reference roman/offline_rpgo/g2o_and_time_to_pose_data.py."""
from roman_tpu_torch.rpgo.g2o_io import g2o_and_time_to_pose_data  # noqa: F401
