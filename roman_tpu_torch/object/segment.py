"""Alias for reference roman/object/segment.py."""
from roman_tpu_torch.map.roman_map import SegmentData
from roman_tpu_torch.map.roman_map import SegmentData as SegmentMinimalData
from roman_tpu_torch.map.segment import Segment  # noqa: F401
