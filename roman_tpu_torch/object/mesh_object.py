"""Alias for reference roman/object/mesh_object.py."""
from roman_tpu_torch.map.objects import MeshObject  # noqa: F401
