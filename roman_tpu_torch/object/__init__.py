"""Alias package mirroring the reference's ``roman.object`` layout
(reference roman/object/*): migrating code can replace ``roman`` with
``roman_tpu_torch`` and keep its imports (as roman_tpu/object does).
Implementations live in roman_tpu_torch.map / roman_tpu_torch.ops."""

from roman_tpu_torch.map.objects import (Ellipsoid, MeshObject, ObjectBase,
                                   PointCloudObject, Polytope)
from roman_tpu_torch.map.objects import ObjectBase as Object
from roman_tpu_torch.map.roman_map import SegmentData
from roman_tpu_torch.map.roman_map import SegmentData as SegmentMinimalData
from roman_tpu_torch.map.segment import Segment

__all__ = ["Object", "ObjectBase", "Segment", "SegmentMinimalData",
           "Ellipsoid", "Polytope", "MeshObject", "PointCloudObject"]
