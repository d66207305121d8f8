"""Alias for reference roman/object/polytope.py."""
from roman_tpu_torch.map.objects import Polytope  # noqa: F401
