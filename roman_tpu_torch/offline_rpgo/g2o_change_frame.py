"""Alias for reference roman/offline_rpgo/g2o_change_frame.py."""
from roman_tpu_torch.rpgo.g2o_utils import g2o_change_frame  # noqa: F401
