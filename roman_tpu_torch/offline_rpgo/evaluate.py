"""Alias for reference roman/offline_rpgo/evaluate.py."""
from roman_tpu_torch.rpgo.evaluate import *  # noqa: F401,F403
