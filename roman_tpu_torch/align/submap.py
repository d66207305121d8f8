"""The Submap names under ``align`` (port of roman_tpu/align/submap.py;
reference roman/align/submap.py). They live in ``map.roman_map``."""

from roman_tpu_torch.map.roman_map import (Submap, SubmapParams,  # noqa: F401
                                           submaps_from_roman_map,
                                           submaps_to_features)
