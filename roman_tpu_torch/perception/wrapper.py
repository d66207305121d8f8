"""Batched perception front end: RGB-D frames -> per-mask observations and
frame descriptors. A port of roman_tpu/perception/wrapper.py.

Parity with reference FastSAMWrapper.run (fastsam_wrapper.py:254-418):
segmentation masks -> filtering (area bounds by min/max_mask_len_div, image
edge contact, keep/ignore label boxes, triangle ignore regions) -> 3D
point-cloud lifting from the depth image with max_depth rejection (a mask
is dropped when <25% of its points are within max_depth,
fastsam_wrapper.py:323,352) -> voxel downsample -> plane filter by OBB
extents (:373-384) -> per-mask semantic embedding (mean per-pixel DINOv2
feature, :407-414, or CLIP bbox crop, :393-406) -> frame descriptor
pooling (:650-666).

Everything up to the Observations runs as torch code on one device over a
batch of frames with capacity-padded masks, with no host sync inside the
batch but one with CLIP semantics (the count of the kept slots, whose
crops alone are encoded). ``run_batch`` rounds its inputs as roman_tpu's
does (images to uint8, depths through float16), so both packages lift the
same points.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from roman_tpu_torch import tracing
from roman_tpu_torch.data.camera import CameraParams, depth_image_to_points
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.map.observation import Observation
from roman_tpu_torch.ops.geometry import obb_volume_extent
from roman_tpu_torch.ops.image import crop_resize, resize_bilinear, resize_nearest
from roman_tpu_torch.ops.voxel import voxel_downsample
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.perception import clip as clip_mod
from roman_tpu_torch.perception import dinov2, fastsam
from roman_tpu_torch.perception.frame_descriptor import frame_descriptor
from roman_tpu_torch.perception.vit import ViT, init_vit_

# crops the CLIP tower encodes at once: its CUDA graph's batch, replayed
# once a chunk of the kept slots. On the H100 (PERF.md, section 6) smaller
# chunks waste less on padding but run each crop slower: with every one of
# 512 slots kept, 32 took 6.4% longer than one batch of 512, 128 took 2.0%
CLIP_CHUNK = 128

SEG_ARCHS = {"fastsam-x": fastsam.FASTSAM_X, "fastsam-s": fastsam.FASTSAM_S,
             "tiny": fastsam.TINY_TEST}
VIT_ARCHS = {"dinov2-base": dinov2.DINOV2_BASE, "dinov2-small": dinov2.DINOV2_SMALL,
             "tiny": dataclasses.replace(dinov2.DINOV2_SMALL, width=64, depth=2, heads=4,
                                         img_size=84, dtype=torch.float32)}


@dataclasses.dataclass
class PerceptionOutput:
    """Padded outputs for a batch of frames, on the host. Masks are at
    mask_downsample_factor resolution; full-resolution masks are consumed
    on the device (embedding and lifting)."""

    masks: np.ndarray          # (B, K, H/f, W/f) bool (downsampled)
    valid: np.ndarray          # (B, K)
    points: np.ndarray         # (B, K, P, 3) camera-frame object points
    points_valid: np.ndarray   # (B, K, P)
    embeddings: np.ndarray     # (B, K, D)
    frame_descriptors: np.ndarray  # (B, D)


def _net(model: torch.nn.Module, weights, init, generator, device):
    if weights is None:
        init(model, generator)
    else:
        model.load_state_dict(weights)
    return model.to(device).eval().requires_grad_(False)


class PerceptionFrontend:
    """The segmentation net and DINOv2 (or CLIP) in one batched program,
    honoring the FastSAMParams filtering pipeline: rotate_img -> YOLO
    ignore/keep label boxes -> triangle ignore regions -> area bounds /
    edge filter -> erosion-gated depth lifting -> plane filter ->
    per-mask semantics (mean-DINO or CLIP bbox crop).

    With CLIP semantics the crops of the slots the filters kept are
    encoded after the filters, in a stage of their own (clip_stage: span
    ``perception.clip``; counters ``perception.clip_crops``, the slots
    given to the stage, ``perception.clip_encoded``, the crops the tower
    ran, chunks' padding included, and ``perception.clip_kept``, the slots
    kept, while a profiler records). A dropped slot's embedding is 0.

    Weights are state dicts of the port's modules (the upstream loaders of
    ``dinov2``, ``clip`` and ``fastsam``, or ``roman_tpu_torch.convert`` from
    roman_tpu's flax variables); a net given none gets seeded random
    weights, drawn on the CPU from one ``torch.Generator(seed)`` so every
    device computes with the same ones. Runs on `device` (None means
    ``cuda``; a host without a card raises unless given ``device="cpu"``).

    As in roman_tpu, YOLO label filtering runs only when `ignore_people`
    or `use_keep_labels` is set (the reference always runs YOLOv7 when
    ignore_labels is nonempty, fastsam_wrapper.py:176)."""

    def __init__(self, params: FastSAMParams, camera: CameraParams,
                 seg_cfg: Optional[fastsam.YoloSegConfig] = None, vit_cfg=None,
                 seg_weights=None, vit_weights=None,
                 yolo_cfg: Optional[fastsam.YoloSegConfig] = None, yolo_weights=None,
                 yolo_label_names: Optional[tuple] = None,
                 clip_cfg=None, clip_weights=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.camera = camera
        self.seg_cfg = seg_cfg if seg_cfg is not None else SEG_ARCHS[params.seg_arch]
        self.vit_cfg = vit_cfg if vit_cfg is not None else VIT_ARCHS[params.vit_arch]
        gen = torch.Generator().manual_seed(seed)
        self.seg_model = _net(fastsam.YoloSeg(self.seg_cfg), seg_weights,
                              fastsam.init_yoloseg_, gen, self.device)
        self.vit_model = _net(ViT(self.vit_cfg), vit_weights, init_vit_, gen, self.device)

        # YOLO label-filter stand-in (reference fastsam_wrapper.py:171,
        # :440-484): a YoloSeg detect head with nc > 1
        self.run_yolo = bool((params.ignore_people and len(params.ignore_labels) > 0)
                             or params.use_keep_labels)
        self.yolo_model = None
        self.yolo_label_names = yolo_label_names or COCO_NAMES
        if self.run_yolo:
            self.yolo_cfg = yolo_cfg or dataclasses.replace(
                fastsam.FASTSAM_X, nc=len(self.yolo_label_names), depth_mult=0.33,
                width_mult=0.25)
            self.yolo_model = _net(fastsam.YoloSeg(self.yolo_cfg), yolo_weights,
                                   fastsam.init_yoloseg_, gen, self.device)

        # CLIP bbox-crop semantics (reference fastsam_wrapper.py:393-406);
        # fastsam_wrapper.py:182 loads ViT-L/14 (768-d projected embeddings)
        self.clip_model = None
        if params.semantics == "clip":
            self.clip_cfg = clip_cfg or clip_mod.CLIP_VIT_L14
            self.clip_model = _net(ViT(self.clip_cfg), clip_weights, init_vit_, gen,
                                   self.device)
        self._tri_cache = {}
        self._graphs = {}
        self._K = torch.tensor(np.asarray(camera.K), dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------------------ #
    def _ignore_keep_ids(self):
        names = list(self.yolo_label_names)
        ignore = [names.index(lb) for lb in self.params.ignore_labels if lb in names]
        keep = [names.index(lb) for lb in self.params.keep_labels if lb in names]
        return tuple(ignore), tuple(keep)

    def _tri_mask(self, H: int, W: int) -> torch.Tensor:
        key = (H, W)
        if key not in self._tri_cache:
            self._tri_cache[key] = torch.as_tensor(
                triangle_ignore_mask(self.params.triangle_ignore_masks, H, W),
                device=self.device)
        return self._tri_cache[key]

    @property
    def embedding_dim(self) -> int:
        if self.clip_model is not None:
            return self.clip_cfg.proj_dim or self.clip_cfg.width
        return self.vit_cfg.width

    # ------------------------------------------------------------------ #
    def segment(self, imgs_p: torch.Tensor):
        """FastSAM everything mode on rotated images (B, 3, Hr, Wr) -> (masks
        at (Hr, Wr) (B, K, Hr, Wr) bool, keep (B, K), the anchor each
        proposal came from (B, K))."""
        p = self.params
        Hr, Wr = imgs_p.shape[-2:]
        hw = (_r32(p.imgsz[0]), _r32(p.imgsz[1]))
        out = self.seg_model(resize_bilinear(imgs_p, hw))
        idx, boxes, _, coeffs, keep = fastsam.select_proposals(
            out, self.seg_cfg, hw, p.conf, p.iou, p.max_masks_per_frame)
        masks_s = fastsam.assemble_masks(out["proto"], coeffs, boxes, hw) & keep[..., None, None]
        masks_r = resize_nearest(masks_s.float(), (Hr, Wr)) > 0.5
        return masks_r, keep, idx

    def label_filter(self, imgs_p: torch.Tensor, masks_r: torch.Tensor,
                     ok: torch.Tensor) -> torch.Tensor:
        """YOLO ignore/keep label boxes (fastsam_wrapper.py:440-484): drop
        masks overlapping any ignore-label box; with use_keep_labels keep
        only masks with >= keep_mask_minimal_intersection inside the union
        of the keep-label boxes."""
        p = self.params
        Hr, Wr = imgs_p.shape[-2:]
        yh, yw = _r32(p.yolo_imgsz[0]), _r32(p.yolo_imgsz[1])
        ybox, ycls, _, yvalid = fastsam.detect_labeled(
            self.yolo_model, resize_bilinear(imgs_p, (yh, yw)))
        sx, sy = Wr / yw, Hr / yh
        ybox = ybox * torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                   device=ybox.device)
        ignore_ids, keep_ids = self._ignore_keep_ids()

        def boxes_of(ids):
            hit = yvalid & torch.isin(ycls, torch.tensor(ids, dtype=torch.int32,
                                                          device=ycls.device))
            return torch.where(hit[..., None], ybox, torch.zeros_like(ybox))

        keep_boxes = boxes_of(keep_ids) if p.use_keep_labels else None
        # the reference drops a mask on ANY ignore overlap (:551-553)
        return apply_label_filters(masks_r, ok, ignore_boxes=boxes_of(ignore_ids),
                                   keep_boxes=keep_boxes, ignore_frac=1e-9,
                                   keep_frac=p.keep_mask_minimal_intersection)

    def semantics(self, imgs_p: torch.Tensor, masks_r: torch.Tensor):
        """(embeddings (B, K, D), frame descriptors (B, D_vit), patch tokens
        (B, gh, gw, D_vit) float32) on the rotated image. With CLIP
        semantics the embeddings are None here: clip_stage makes them."""
        p = self.params
        B, _, Hr, Wr = imgs_p.shape
        K = masks_r.shape[1]
        p14 = self.vit_cfg.patch
        gh, gw = (Hr // p14) * p14, (Wr // p14) * p14
        vit_in = dinov2.normalize(resize_bilinear(imgs_p, (gh, gw)),
                                  dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD)
        _, patches = self.vit_model(vit_in)
        patches = patches.float()
        if self.clip_model is not None:
            emb = None  # the CLIP stage, after the filters (program)
        else:
            # mean per-pixel DINO embedding (fastsam_wrapper.py:407-414) as
            # mask-weighted patch pooling: each patch token weighted by the
            # share of its pixels in the mask, without the (B, H, W, D)
            # per-pixel feature tensor
            mg = resize_nearest(masks_r.float(), (gh, gw))
            w = F.avg_pool2d(mg, p14).reshape(B, K, -1)                 # (B, K, T)
            emb = torch.bmm(w, patches.reshape(B, -1, patches.shape[-1]))
            emb = emb / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                    min=1e-9)
        fdesc = frame_descriptor(patches, p.frame_descriptor or "dino-gem")
        return emb, fdesc, patches

    def mask_filters(self, masks: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """Triangle ignore regions, area bounds and edge contact on the
        camera-frame masks (B, K, H, W)."""
        p = self.params
        H, W = masks.shape[-2:]
        # triangle ignore regions (constant_ignore_mask,
        # fastsam_wrapper.py:196-204): any overlap drops the mask
        tri = self._tri_mask(H, W)
        ok = ok & ~(masks & tri).flatten(2).any(dim=-1)
        # area bounds (from_params: img_area / div^2, fastsam_wrapper.py:129)
        area = masks.flatten(2).sum(dim=-1)
        ok = ok & (area >= H * W / p.min_mask_len_div ** 2) & (
            area <= H * W / p.max_mask_len_div ** 2)
        # edge contact (5 px, per-side allow flags; reference
        # _delete_edge_masks :486-495). The flags name the ROTATED image's
        # sides; these masks are un-rotated, so permute the flags onto the
        # camera-frame edges they correspond to
        perm = {None: (0, 1, 2, 3), "CCW": (2, 3, 1, 0),
                "CW": (3, 2, 0, 1), "180": (1, 0, 3, 2)}[p.rotate_img]
        allow = tuple(p.allow_tblr_edges[i] for i in perm)
        edges = (masks[..., :5, :], masks[..., -5:, :], masks[..., :, :5],
                 masks[..., :, -5:])
        for band, allowed in zip(edges, allow):
            if not allowed:
                ok = ok & ~band.flatten(2).any(dim=-1)
        return ok

    def lift(self, masks: torch.Tensor, depths: torch.Tensor):
        """Depth -> object point clouds (fastsam_wrapper.py:340-384):
        (points (B, K, P, 3), points_valid (B, K, P)) after the voxel
        downsample. Erosion gates only the depth pixels (:331-335); the
        stored masks stay un-eroded."""
        p = self.params
        B, K = masks.shape[:2]
        n_pts = p.max_points_per_mask
        # pixel stride for lifting (reference pcd_stride, :215)
        s = max(p.pcd_stride, 1)
        if p.erosion_size > 0:
            lift = erode_masks(masks, 2 * p.erosion_size + 1, stride=s)
        else:
            lift = masks[..., ::s, ::s]
        pts = depth_image_to_points(depths, self._K)[:, ::s, ::s].reshape(B, 1, -1, 3)
        d = depths[:, None, ::s, ::s]
        sel = lift & (d > 1e-3)
        near = d <= p.max_depth
        n_all = sel.flatten(2).sum(dim=-1)
        n_near = (sel & near).flatten(2).sum(dim=-1)
        # max_depth rejection: <25% of the points within max_depth
        frac_ok = n_near >= 0.25 * torch.clamp(n_all, min=1)
        flat = (sel & near).flatten(2)                                   # (B, K, n)
        n = flat.shape[-1]
        k_eff = min(n_pts, n)
        jitter = 1.0 + 0.5 * _hash01(torch.arange(n, device=flat.device))
        idx = torch.topk(flat.float() * jitter, k_eff, dim=-1).indices  # (B, K, k_eff)
        pv = (torch.gather(flat, -1, idx) & (n_all > 0)[..., None] & frac_ok[..., None])
        out_p = torch.gather(pts.expand(B, K, n, 3), 2, idx[..., None].expand(B, K, k_eff, 3))
        if k_eff < n_pts:  # strided image smaller than the capacity
            out_p = F.pad(out_p, (0, 0, 0, n_pts - k_eff))
            pv = F.pad(pv, (0, n_pts - k_eff))
        # voxel downsample each mask's points (fastsam_wrapper.py:367)
        return voxel_downsample(out_p, pv, p.voxel_size)

    def nets(self, images: torch.Tensor):
        """The nets' half of the program: rotation, segmentation, proposals
        and masks, the ViT, the embeddings (None with CLIP semantics) and
        frame descriptors. -> (rotated images, masks_r, keep, anchors,
        embeddings, frame descriptors)."""
        # segmentation, YOLO and semantics run on the rotated image; masks
        # are un-rotated before lifting (fastsam_wrapper.py:420-438)
        imgs_p = rotate_images(images, self.params.rotate_img)
        masks_r, keep, anchors = self.segment(imgs_p)
        emb, fdesc, _ = self.semantics(imgs_p, masks_r)
        return imgs_p, masks_r, keep, anchors, emb, fdesc

    @torch.no_grad()
    def program(self, images: torch.Tensor, depths: torch.Tensor, graph: bool = True) -> dict:
        """The batch program on the device: images (B, 3, H, W) float in
        [0, 1], depths (B, H, W) float32 m -> dict of device tensors: the
        PerceptionOutput fields (masks downsampled by
        mask_downsample_factor) and the anchor of each proposal.

        On a CUDA device the nets' half replays a CUDA graph captured on
        the first batch of each shape, and the CLIP tower one of
        CLIP_CHUNK crops, once a chunk of the kept slots (_Graph: the same
        kernels, launched by the graph instead of one by one from Python);
        graph=False launches them eagerly, the graphs' referee."""
        p = self.params
        imgs_p, masks_r, ok, anchors, emb, fdesc = self._replay(
            tuple(images.shape), self.nets, graph, images)
        if self.run_yolo:
            ok = self.label_filter(imgs_p, masks_r, ok)
        rot = p.rotate_img
        unrot = {None: None, "CW": "CCW", "CCW": "CW", "180": "180"}[rot]
        masks = rotate_images(masks_r, unrot)
        ok = self.mask_filters(masks, ok)
        pts, pts_v = self.lift(masks, depths)
        # plane filter via OBB extents (fastsam_wrapper.py:373-384): reject
        # extents that look like [big, big, thin]
        _, extent = obb_volume_extent(pts, pts_v)
        e = torch.sort(extent, dim=-1).values
        a, b, c = p.plane_filter_params
        plane = (e[..., 2] > a) & (e[..., 1] > b) & (e[..., 0] < c)
        ok = ok & ~plane & (pts_v.sum(dim=-1) > 0)
        if self.clip_model is not None:
            # CLIP crop semantics on the masks the filters kept, as upstream
            # embeds them (fastsam_wrapper.py:393-406)
            emb = self.clip_stage(imgs_p, masks_r, ok, graph)
        f = p.mask_downsample_factor
        return dict(masks=masks[:, :, ::f, ::f], valid=ok, points=pts, points_valid=pts_v,
                    embeddings=emb, frame_descriptors=fdesc, anchors=anchors)

    def clip_stage(self, imgs_p: torch.Tensor, masks_r: torch.Tensor, ok: torch.Tensor,
                   graph: bool = True) -> torch.Tensor:
        """CLIP embeddings (B, K, D) of the box crops of masks_r (B, K, H,
        W) on the rotated images (clip_bbox_embeddings): unit vectors at
        the slots ok (B, K) keeps, 0 at the others. The kept slots' indices
        are found first, outside the span: on the card the batch's one wait,
        for their count."""
        tracing.count_sync(ok.device)
        kept = torch.nonzero(ok.flatten()).squeeze(1)
        with tracing.span("perception.clip"):
            emb = clip_bbox_embeddings(
                imgs_p, _mask_bboxes(masks_r),
                lambda crops: (self._encode_kept(crops, kept, graph), None),
                out_size=self.clip_cfg.img_size)
        tracing.count("perception.clip_crops", ok.numel())
        tracing.count("perception.clip_encoded", -(-len(kept) // CLIP_CHUNK) * CLIP_CHUNK)
        tracing.count_device("perception.clip_kept", ok)
        return emb

    def _encode_kept(self, crops: torch.Tensor, kept: torch.Tensor, graph: bool) -> torch.Tensor:
        """The CLIP tower's class-token embeddings (N, D) of the rows
        `kept` of crops (N, 3, S, S), 0 in the other rows. The tower runs
        on chunks of CLIP_CHUNK rows, the last padded with its last row,
        each chunk on the card a replay of one CUDA graph (eagerly the same
        chunks, so both give the same bits); with no row kept it does not
        run."""
        out = crops.new_zeros(len(crops), self.embedding_dim)
        key = ("clip", CLIP_CHUNK) + tuple(crops.shape[1:])
        for s in range(0, len(kept), CLIP_CHUNK):
            rows = kept[s:s + CLIP_CHUNK]
            n = len(rows)
            idx = torch.cat([rows, rows[-1:].expand(CLIP_CHUNK - n)])
            out[rows] = self._replay(key, self._clip_tower, graph, crops[idx])[:n]
        return out

    def _clip_tower(self, crops: torch.Tensor) -> torch.Tensor:
        return self.clip_model(crops)[0]

    def _replay(self, key: tuple, fn, graph: bool, *inputs):
        """fn(*inputs), on a CUDA device with graph by the CUDA graph of
        `key`, captured on its first call."""
        if not (graph and self.device.type == "cuda"):
            return fn(*inputs)
        if key not in self._graphs:
            self._graphs[key] = _Graph(fn, inputs)
        return self._graphs[key](*inputs)

    def inputs(self, images: np.ndarray, depths: np.ndarray):
        """Host frames -> the program's device inputs, rounded as roman_tpu's
        run_batch rounds them: images (B, H, W, 3) float [0, 1] or uint8 to
        uint8 (np.clip(x * 255, 0, 255).astype(uint8), in the images' own
        dtype), then to [0, 1]; depths (B, H, W) m through float16. The
        rounding runs on the device, bit for bit numpy's."""
        img = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        if img.dtype != torch.uint8:
            img = (img * 255.0).clamp(0, 255).to(torch.uint8)
        # contiguous NCHW: the graph's input buffer is, and the kernels (and
        # their rounding) that resizes and convolutions pick follow the layout
        img = img.permute(0, 3, 1, 2).float().contiguous() * dinov2.INV_255
        dep = torch.from_numpy(np.ascontiguousarray(depths)).to(self.device)
        return img, dep.to(torch.float16).float()

    def run_batch(self, images: np.ndarray, depths: np.ndarray) -> PerceptionOutput:
        """images (B, H, W, 3) float [0, 1] or uint8; depths (B, H, W) m."""
        out = self.program(*self.inputs(images, depths))
        return PerceptionOutput(**{f.name: out[f.name].cpu().numpy()
                                   for f in dataclasses.fields(PerceptionOutput)})

    def observations(self, out: PerceptionOutput, times, poses) -> List[List[Observation]]:
        """Padded outputs -> per-frame Observation lists (the Mapper's input
        contract, mapper.py:47)."""
        all_obs: List[List[Observation]] = []
        for b in range(len(out.valid)):
            frame_obs = []
            for k in np.flatnonzero(out.valid[b]):
                pv = out.points_valid[b, k].astype(bool)
                if not pv.any():
                    continue
                frame_obs.append(Observation(
                    time=float(times[b]), pose=np.asarray(poses[b]), mask=None,
                    mask_downsampled=out.masks[b, k], point_cloud=out.points[b, k][pv],
                    semantic_descriptor=out.embeddings[b, k]))
            all_obs.append(frame_obs)
        return all_obs


class _Graph:
    """fn over device tensors of fixed shapes, captured as a CUDA graph and
    replayed from static input buffers: a batch of FastSAM-x and
    DINOv2-base is ~3,000 small kernels, and issuing them one by one from
    Python left the card idle about half the time. Outputs (a tensor or a
    tuple of tensors and Nones) are cloned out of the graph's buffers,
    which the next replay overwrites."""

    def __init__(self, fn, inputs):
        dev = inputs[0].device
        self.inputs = [torch.zeros(x.shape, dtype=x.dtype, device=dev) for x in inputs]
        # a first run on a side stream does the lazy initializations that
        # capture does not allow (torch.cuda.graphs' warmup)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.inputs)

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        if isinstance(self.out, torch.Tensor):
            return self.out.clone()
        return tuple(None if t is None else t.clone() for t in self.out)


def clip_bbox_embeddings(images: torch.Tensor, boxes: torch.Tensor, clip_model,
                         out_size: int = 224) -> torch.Tensor:
    """Per-mask CLIP embeddings from bbox crops (reference
    fastsam_wrapper.py:393-406): crop each mask's box, resample it to the
    CLIP input size, encode, normalize.

    images (B, 3, H, W) float [0, 1]; boxes (B, K, 4) xyxy pixels -> (B, K,
    D) unit embeddings.
    """
    B, K = boxes.shape[:2]
    crops = crop_resize(images, boxes, out_size)              # (B, K, 3, S, S)
    crops = dinov2.normalize(crops.reshape(B * K, 3, out_size, out_size),
                             clip_mod.CLIP_MEAN, clip_mod.CLIP_STD)
    cls_out, _ = clip_model(crops)
    emb = cls_out.reshape(B, K, -1).float()
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-9)


def apply_label_filters(masks: torch.Tensor, valid: torch.Tensor,
                        ignore_boxes: Optional[torch.Tensor] = None,
                        keep_boxes: Optional[torch.Tensor] = None,
                        ignore_frac: float = 0.5, keep_frac: float = 0.5) -> torch.Tensor:
    """Label-box mask filtering (reference fastsam_wrapper.py:440-484).

    - ignore_boxes (B, I, 4) xyxy (zero rows = padding): a mask is dropped
      when more than ignore_frac of its area falls inside any ignore box.
    - keep_boxes (B, K2, 4): a mask must have at least keep_frac of its
      area inside the union of the keep boxes (fastsam_wrapper.py:560).
    """
    B, K, H, W = masks.shape
    m = masks.float()
    # per-mask summed-area table: a box's mask-pixel count is 4 lookups
    sat = F.pad(m, (1, 0, 1, 0)).cumsum(dim=-2).cumsum(dim=-1)   # (B, K, H+1, W+1)
    sat_flat = sat.reshape(B, K, (H + 1) * (W + 1))
    area = torch.clamp(m.sum(dim=(-2, -1)), min=1.0)

    def box_corners(boxes):
        # reference pixel semantics (fastsam_wrapper.py:455-480): boxes
        # truncate to int, cover the EXCLUSIVE slice [x0:x1) clipped to the
        # image; zero-extent rows (padding) are empty
        b = torch.trunc(boxes).to(torch.int64)
        x1, y1 = b[..., 0].clamp(0, W), b[..., 1].clamp(0, H)
        x2, y2 = b[..., 2].clamp(0, W), b[..., 3].clamp(0, H)
        return x1, y1, x2, y2, (x2 > x1) & (y2 > y1)

    def frac_in_boxes(boxes):
        # (B, nb, 4) -> (B, K): the largest fraction of the mask in one box
        x1, y1, x2, y2, box_valid = box_corners(boxes)

        def corner(yy, xx):
            idx = (yy * (W + 1) + xx)[:, None, :]
            return torch.gather(sat_flat, -1, idx.expand(B, K, idx.shape[-1]))

        inter = corner(y2, x2) - corner(y1, x2) - corner(y2, x1) + corner(y1, x1)
        inter = torch.where(box_valid[:, None, :], inter, torch.zeros_like(inter))
        return (inter / area[:, :, None]).max(dim=-1).values

    def frac_in_union(boxes):
        # (B, nb, 4) -> (B, K): the fraction of the mask inside the union
        x1, y1, x2, y2, box_valid = box_corners(boxes)
        xs = torch.arange(W, device=masks.device)
        ys = torch.arange(H, device=masks.device)
        inx = (xs >= x1[..., None]) & (xs < x2[..., None])          # (B, nb, W)
        iny = (ys >= y1[..., None]) & (ys < y2[..., None])          # (B, nb, H)
        cell = iny[..., :, None] & inx[..., None, :] & box_valid[..., None, None]
        union = cell.any(dim=1)                                     # (B, H, W)
        inter = (m * union[:, None].float()).sum(dim=(-2, -1))
        return inter / area

    ok = valid
    if ignore_boxes is not None:
        ok = ok & (frac_in_boxes(ignore_boxes) < ignore_frac)
    if keep_boxes is not None:
        ok = ok & (frac_in_union(keep_boxes) >= keep_frac)
    return ok


def _ellipse_footprint(ksize: int) -> np.ndarray:
    """cv.getStructuringElement(cv.MORPH_ELLIPSE, (ksize, ksize)): OpenCV's
    per-row ellipse fill with round-to-nearest half-widths (a (7,7)
    ellipse is rows of 1,5,7,7,7,5,1 pixels)."""
    r = ksize // 2
    fp = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(r * np.sqrt(max(r * r - dy * dy, 0) / max(r * r, 1))))
            fp[i, r - dx:r + dx + 1] = True
    return fp


def erode_masks(masks: torch.Tensor, size: int, stride: int = 1) -> torch.Tensor:
    """Binary erosion with the reference's (size, size) MORPH_ELLIPSE
    element (fastsam_wrapper.py:246-249 + cv.erode): a pixel survives iff
    every footprint pixel is set; the border counts as foreground (padding
    with ones). `stride` keeps every stride-th row and column of the
    result, computing only those (erode(masks)[..., ::s, ::s])."""
    if size <= 1:
        return masks[..., ::stride, ::stride]
    B, K, H, W = masks.shape
    fp = _ellipse_footprint(size)
    e = size // 2
    x = F.pad(masks.float().reshape(B * K, 1, H, W), (e, e, e, e), value=1.0)
    kern = torch.tensor(fp, dtype=torch.float32, device=masks.device)[None, None]
    hits = F.conv2d(x, kern, stride=stride)
    return (hits >= fp.sum() - 0.5).reshape(B, K, hits.shape[-2], hits.shape[-1])


def _clip_line(W: int, H: int, p1, p2):
    """OpenCV's clipLine, in its integer and double arithmetic: (p1, p2,
    inside) with the endpoints as it leaves them (clipped when the segment
    meets the image)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = W - 1, H - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _line8(mask: np.ndarray, p0, p1):
    """cv.line(..., lineType=LINE_8): OpenCV's LineIterator on the segment
    clipped to the image, drawn left to right."""
    H, W = mask.shape
    (x0, y0), (x1, y1), inside = _clip_line(W, H, p0, p1)
    if not inside:
        return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        mask[y, x] = True
        diag = err < 0
        err += -2 * minor + (2 * major if diag else 0)
        if steep:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0


def _c_div(num: int, den: int) -> int:
    """int64 division truncated toward zero, as C++'s."""
    q = abs(num) // abs(den)
    return q if (num < 0) == (den < 0) else -q


def _fill_poly(mask: np.ndarray, pts):
    """cv.fillPoly(mask, [pts], 1) for one polygon with integer vertices
    (shift 0, LINE_8), as OpenCV draws it: every edge as an 8-connected
    line, then each scanline filled between pairs of the edges that cross
    it, from ceil(x_left) to floor(x_right), clipped to the image. Edge x is
    16.16 fixed point stepped by a truncated slope; an edge that leaves the
    image takes its x and slope from the clipped segment (a constant x when
    that segment is horizontal)."""
    H, W = mask.shape
    one = 1 << 16
    edges = []
    for i in range(len(pts)):
        (xa, ya), (xb, yb) = pts[i - 1], pts[i]
        _line8(mask, (xa, ya), (xb, yb))
        if ya == yb:
            continue
        c0, c1 = (xa * one, ya), (xb * one, yb)
        slope = None
        if not (0 <= xa < W and 0 <= xb < W and 0 <= ya < H and 0 <= yb < H):
            t0, t1, inside = _clip_line(W, H, (xa, ya), (xb, yb))
            if t0[1] != t1[1]:
                c0, c1 = (t0[0] * one, t0[1]), (t1[0] * one, t1[1])
            elif inside:
                c0, c1, slope = (t0[0] * one, ya), (t1[0] * one, yb), 0
        if slope is None:
            slope = _c_div(c1[0] - c0[0], c1[1] - c0[1])
        if ya < yb:
            edges.append((ya, yb, c0[0] + (ya - c0[1]) * slope, slope))
        else:
            edges.append((yb, ya, c1[0] + (yb - c1[1]) * slope, slope))
    if len(edges) < 2:
        return
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), H)):
        xs = sorted(x + (y - y0) * s for y0, y1, x, s in edges if y0 <= y < y1)
        for xl, xr in zip(xs[0::2], xs[1::2]):
            x1, x2 = (xl + one - 1) >> 16, xr >> 16
            if x1 < W and x2 >= 0:
                mask[y, max(x1, 0):min(x2, W - 1) + 1] = True


def triangle_ignore_mask(triangles, H: int, W: int) -> np.ndarray:
    """Pixel mask of the triangle ignore regions (reference
    fastsam_params.triangle_ignore_masks, applied at
    fastsam_wrapper.py:426-438); True = ignored pixel. roman_tpu fills them
    with cv2.fillPoly; this is the same fill in numpy."""
    mask = np.zeros((H, W), bool)
    for tri in triangles or []:
        _fill_poly(mask, [tuple(int(v) for v in pt) for pt in np.asarray(tri).reshape(-1, 2)])
    return mask


def rotate_images(images: torch.Tensor, how: Optional[str]) -> torch.Tensor:
    """Rotation of (..., H, W) images or masks ('CW', 'CCW', '180';
    reference fastsam_wrapper.py:420-438)."""
    if how is None:
        return images
    k = {"CCW": 1, "180": 2, "CW": 3}[how]
    return torch.rot90(images, k=k, dims=(-2, -1))


def _mask_bboxes(masks: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) bool -> (B, K, 4) xyxy pixel boxes (reference
    mask_bounding_box, fastsam_wrapper.py:577-600): a width x height box
    (from the mask's extents) re-centered on the mask's pixel centroid and
    clipped to the image. x2/y2 are exclusive (+1 on the reference's
    inclusive values). Empty masks get a 1 px box at the origin."""
    B, K, H, W = masks.shape
    any_row = masks.any(dim=-1)                              # (B, K, H)
    any_col = masks.any(dim=-2)                              # (B, K, W)
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)
    big = 1e9
    y1 = torch.where(any_row, ys, big).min(dim=-1).values
    y2 = torch.where(any_row, ys, -big).max(dim=-1).values   # inclusive
    x1 = torch.where(any_col, xs, big).min(dim=-1).values
    x2 = torch.where(any_col, xs, -big).max(dim=-1).values
    mf = masks.float()
    n = torch.clamp(mf.sum(dim=(-2, -1)), min=1.0)
    cy = (mf.sum(dim=-1) * ys).sum(dim=-1) / n               # centroid row
    cx = (mf.sum(dim=-2) * xs).sum(dim=-1) / n               # centroid col
    hh = torch.floor((y2 - y1 + 1.0) / 2.0)
    hw = torch.floor((x2 - x1 + 1.0) / 2.0)
    y1n = torch.floor(torch.clamp(cy - hh, min=0.0))
    y2n = torch.floor(torch.clamp(cy + hh, max=H - 1.0))
    x1n = torch.floor(torch.clamp(cx - hw, min=0.0))
    x2n = torch.floor(torch.clamp(cx + hw, max=W - 1.0))
    empty = ~any_row.any(dim=-1)
    box = torch.stack([x1n, y1n, x2n + 1.0, y2n + 1.0], dim=-1)
    origin = torch.zeros_like(box)
    origin[..., 2:] = 1.0
    return torch.where(empty[..., None], origin, box)


# COCO-80 class names: the label vocabulary of the reference's YOLOv7
# detector (ignore_labels/keep_labels entries are looked up here)
COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


def _r32(x: int) -> int:
    return max(32, (int(x) // 32) * 32)


def _hash01(i: torch.Tensor) -> torch.Tensor:
    """Cheap deterministic per-index jitter in [0, 1) for subsampling."""
    return ((i * 48271) % 65536).float() / 65536.0
