"""Alias for reference roman/offline_rpgo/plot_g2o.py."""
from roman_tpu_torch.rpgo.plot_g2o import *  # noqa: F401,F403
