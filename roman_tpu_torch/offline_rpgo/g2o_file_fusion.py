"""Alias for reference roman/offline_rpgo/g2o_file_fusion.py."""
from roman_tpu_torch.rpgo.fusion import *  # noqa: F401,F403
