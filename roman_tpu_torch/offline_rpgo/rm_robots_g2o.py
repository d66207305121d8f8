"""Alias for reference roman/offline_rpgo/rm_robots_g2o.py."""
from roman_tpu_torch.rpgo.g2o_utils import rm_robots  # noqa: F401
from roman_tpu_torch.rpgo.plot_g2o import rm_robots_g2o  # noqa: F401
