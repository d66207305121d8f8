"""Alias for reference roman/object/object.py."""
from roman_tpu_torch.map.objects import ObjectBase, ObjectBase as Object  # noqa: F401
