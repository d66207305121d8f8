"""Alias for reference roman/object/ellipsoid.py."""
from roman_tpu_torch.map.objects import Ellipsoid  # noqa: F401
