"""Alias for reference roman/offline_rpgo/extract_odom_g2o.py."""
from roman_tpu_torch.map.roman_map import RomanMap  # noqa: F401
from roman_tpu_torch.rpgo.extract_odom import *  # noqa: F401,F403
