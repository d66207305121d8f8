"""Alias for reference roman/offline_rpgo/combine_loop_closures.py."""
from roman_tpu_torch.rpgo.combine_loop_closures import *  # noqa: F401,F403
