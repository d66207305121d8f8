"""Perception (segmentation + embedding) params: a host copy of
roman_tpu/params/fastsam_params.py, with the yaml schema of reference
roman/params/fastsam_params.py:57-95. ``device`` is kept for schema
compatibility and ignored (the front end takes its device as an argument).
``perception.wrapper.PerceptionFrontend`` reads the rest: ``seg_arch``,
``vit_arch`` and ``semantics`` pick the nets, ``imgsz``/``yolo_imgsz``
their input sizes, ``conf``/``iou``/``max_masks_per_frame`` the NMS, the
mask filters read ``ignore_*``/``keep_*``, ``triangle_ignore_masks``,
``min/max_mask_len_div``, ``allow_tblr_edges`` and ``rotate_img``, lifting
reads ``erosion_size``, ``pcd_stride``, ``max_depth``,
``max_points_per_mask``, ``voxel_size`` and ``plane_filter_params``, and
``frame_descriptor`` picks the pooling; ``map.run.MapRunner`` reads
``batch_frames``. ``weights_path``, ``yolo_weights_path``,
``use_pointcloud``, ``keep_labels_option`` and ``depth_scale`` are schema
only."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import yaml


@dataclasses.dataclass
class FastSAMParams:
    weights_path: str = "$ROMAN_WEIGHTS/FastSAM-x.pt"
    yolo_weights_path: str = "$ROMAN_WEIGHTS/yolov7.pt"
    imgsz: Tuple[int, int] = (256, 256)
    device: str = "tpu"  # schema compatibility; not read
    use_pointcloud: bool = False
    mask_downsample_factor: int = 8
    min_mask_len_div: int = 30
    max_mask_len_div: int = 3
    ignore_people: bool = False
    erosion_size: int = 3
    voxel_size: float = 0.05
    ignore_labels: tuple = ("person",)
    use_keep_labels: bool = False
    keep_labels: tuple = ()
    keep_labels_option: Optional[Dict] = None
    plane_filter_params: tuple = (3.0, 1.0, 0.2)
    rotate_img: Optional[str] = None
    semantics: str = "dino"
    frame_descriptor: Optional[str] = "dino-gem"
    yolo_imgsz: Tuple[int, int] = (256, 256)
    depth_scale: float = 1e3
    max_depth: float = 7.5
    pcd_stride: int = 4  # depth-lifting pixel stride (reference
                         # setup_rgbd_params default, fastsam_wrapper.py:215)
    triangle_ignore_masks: Optional[List] = None
    conf: float = 0.5
    iou: float = 0.9
    allow_tblr_edges: tuple = (True, True, True, True)
    keep_mask_minimal_intersection: float = 0.3
    # frame batching (fixed shapes; additions over the reference schema)
    batch_frames: int = 8
    max_masks_per_frame: int = 64
    max_points_per_mask: int = 256
    # network architecture selection (the reference picks nets via weight
    # files; here the arch is explicit so tests/benches can shrink it)
    seg_arch: str = "fastsam-x"    # fastsam-x | fastsam-s | tiny
    vit_arch: str = "dinov2-base"  # dinov2-base | dinov2-small | tiny

    def __post_init__(self):
        if self.frame_descriptor is not None and self.frame_descriptor.lower() == "none":
            self.frame_descriptor = None

    @classmethod
    def from_yaml(cls, yaml_path: str, run: Optional[str] = None) -> "FastSAMParams":
        with open(yaml_path) as f:
            data = yaml.safe_load(f)
        if run is not None and run in data:
            data = data[run]
        return cls(**data)
