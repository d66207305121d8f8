"""Alias for reference roman/object/pointcloud_object.py."""
from roman_tpu_torch.map.objects import PointCloudObject  # noqa: F401
