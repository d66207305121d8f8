"""Alias for reference roman/offline_rpgo/edit_g2o_edge_information.py."""
from roman_tpu_torch.rpgo.g2o_io import edit_g2o_edge_information  # noqa: F401
