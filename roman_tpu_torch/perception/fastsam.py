"""FastSAM-style everything-mode segmentation network: a port of
roman_tpu/perception/fastsam.py as torch modules (NCHW).

The reference runs FastSAM-x (a YOLOv8x-seg trained for class-agnostic
"segment everything", CASIA-IVA-Lab/FastSAM) through ultralytics
(fastsam_wrapper.py:90, :517-525). This module holds the YOLOv8-seg
architecture (CSP backbone of Conv-BN-SiLU, C2f and SPPF, PAN-FPN neck,
decoupled detect head with DFL box regression, mask coefficient head and
prototype net) and batched, fixed-shape post-processing (DFL decode,
class-agnostic NMS, prototype-mask assembly).

Numerics follow the flax modules: convolutions take operands in the
config's dtype and return it (bias added after the rounded product);
BatchNorm (running statistics, eps 1e-3) and SiLU run in float32, and the
next convolution casts back. The head's last 1x1 convolutions return the
config's dtype; decoding casts to float32. Module names are the flax ones
(``b2.m0.cv1.conv``), so ``roman_tpu_torch.convert`` carries flax variables
across by name; ``convert_ultralytics_state_dict`` renames an ultralytics
``model.{idx}.*`` state dict onto them.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from roman_tpu_torch.ops.image import resize_bilinear, resize_nearest


@dataclasses.dataclass(frozen=True)
class YoloSegConfig:
    """yolov8{n,s,m,l,x}-seg scaling. FastSAM-x == x scale, nc=1."""

    width_mult: float = 1.25     # x
    depth_mult: float = 1.0      # x
    max_channels: int = 512
    nc: int = 1                  # FastSAM: single "object" class
    reg_max: int = 16
    nm: int = 32                 # mask coefficients
    dtype: torch.dtype = torch.bfloat16

    def ch(self, c: int) -> int:
        return int(min(c, self.max_channels) * self.width_mult)

    def n(self, n: int) -> int:
        return max(round(n * self.depth_mult), 1)


FASTSAM_X = YoloSegConfig(width_mult=1.25, depth_mult=1.0)
# yolov8 scale table: s = (depth 0.33, width 0.50, max_channels 1024)
FASTSAM_S = YoloSegConfig(width_mult=0.5, depth_mult=0.33, max_channels=1024)
TINY_TEST = YoloSegConfig(width_mult=0.125, depth_mult=0.33, nm=8)


class Conv(nn.Conv2d):
    """flax Conv(dtype=dtype) with 'same' padding for odd kernels."""

    def __init__(self, cin: int, cout: int, k: int, s: int, dtype: torch.dtype,
                 bias: bool):
        super().__init__(cin, cout, k, stride=s, padding=k // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.stride,
                     padding=self.padding)
        return y + self.bias.to(dt)[:, None, None] if self.bias is not None else y


class BatchNorm(nn.Module):
    """flax BatchNorm(use_running_average=True, epsilon=1e-3, dtype=f32):
    (x - mean) * (rsqrt(var + eps) * scale) + bias. Inference only (flax
    momentum 0.97 is torch's 0.03; no step here updates the statistics)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvBnSiLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, dtype, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool, dtype):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, cout, 3, dtype=dtype)
        self.cv2 = ConvBnSiLU(cout, cout, 3, dtype=dtype)
        self.add = shortcut and cin == cout

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool, dtype):
        super().__init__()
        c = cout // 2
        self.c, self.n = c, n
        self.cv1 = ConvBnSiLU(cin, 2 * c, 1, dtype=dtype)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut, dtype))
        self.cv2 = ConvBnSiLU((2 + n) * c, cout, 1, dtype=dtype)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBnSiLU(cin, c, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(4 * c, cout, 1, dtype=dtype)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, stride=1, padding=2)
        p2 = F.max_pool2d(p1, 5, stride=1, padding=2)
        p3 = F.max_pool2d(p2, 5, stride=1, padding=2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=1))


def _upsample2(x):
    return resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1]))


class DetectSegHead(nn.Module):
    """One level's decoupled heads: box DFL (4*reg_max), class (nc), mask
    coefficients (nm). Hidden widths follow ultralytics Detect/Segment,
    computed once from the P3 width and shared by all levels."""

    def __init__(self, cfg: YoloSegConfig, cin: int):
        super().__init__()
        c, dt = cfg, cfg.dtype
        ch0 = c.ch(256)
        cb = max(16, ch0 // 4, c.reg_max * 4)
        cc = max(ch0, min(c.nc, 100))
        c4 = max(ch0 // 4, c.nm)
        for name, hidden, out in (("cv2", cb, 4 * c.reg_max), ("cv3", cc, c.nc),
                                  ("cv4", c4, c.nm)):
            self.add_module(f"{name}_0", ConvBnSiLU(cin, hidden, 3, dtype=dt))
            self.add_module(f"{name}_1", ConvBnSiLU(hidden, hidden, 3, dtype=dt))
            self.add_module(f"{name}_2", Conv(hidden, out, 1, 1, dt, bias=True))

    def forward(self, x):
        outs = []
        for name in ("cv2", "cv3", "cv4"):
            h = getattr(self, f"{name}_0")(x)
            h = getattr(self, f"{name}_1")(h)
            outs.append(getattr(self, f"{name}_2")(h))
        return tuple(outs)


class Proto(nn.Module):
    """Mask prototype net, as ultralytics Proto: cv1 Conv3x3 -> learned
    2x2/2 ConvTranspose -> cv2 Conv3x3 -> cv3 Conv-BN-SiLU 1x1."""

    def __init__(self, cfg: YoloSegConfig, cin: int):
        super().__init__()
        cp = max(cfg.ch(256), cfg.nm)
        self.dtype = cfg.dtype
        self.cv1 = ConvBnSiLU(cin, cp, 3, dtype=cfg.dtype)
        self.upsample = nn.ConvTranspose2d(cp, cp, 2, stride=2)
        self.cv2 = ConvBnSiLU(cp, cp, 3, dtype=cfg.dtype)
        self.cv3 = ConvBnSiLU(cp, cfg.nm, 1, dtype=cfg.dtype)

    def forward(self, x):
        dt, up = self.dtype, self.upsample
        x = self.cv1(x)
        x = F.conv_transpose2d(x.to(dt), up.weight.to(dt), stride=2)
        x = x + up.bias.to(dt)[:, None, None]
        return self.cv3(self.cv2(x))


class YoloSeg(nn.Module):
    """images (B, 3, H, W) float in [0, 1], H and W divisible by 32 ->
    {"levels": [(box, cls, mc)] at strides 8/16/32 in the config's dtype,
    "proto": (B, nm, H/4, W/4) float32}."""

    def __init__(self, cfg: YoloSegConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = c
        ch = c.ch
        self.b0 = ConvBnSiLU(3, ch(64), 3, 2, dt)
        self.b1 = ConvBnSiLU(ch(64), ch(128), 3, 2, dt)
        self.b2 = C2f(ch(128), ch(128), c.n(3), True, dt)
        self.b3 = ConvBnSiLU(ch(128), ch(256), 3, 2, dt)
        self.b4 = C2f(ch(256), ch(256), c.n(6), True, dt)
        self.b5 = ConvBnSiLU(ch(256), ch(512), 3, 2, dt)
        self.b6 = C2f(ch(512), ch(512), c.n(6), True, dt)
        self.b7 = ConvBnSiLU(ch(512), ch(1024), 3, 2, dt)
        self.b8 = C2f(ch(1024), ch(1024), c.n(3), True, dt)
        self.b9 = SPPF(ch(1024), ch(1024), dt)
        self.n12 = C2f(ch(1024) + ch(512), ch(512), c.n(3), False, dt)
        self.n15 = C2f(ch(512) + ch(256), ch(256), c.n(3), False, dt)
        self.n16 = ConvBnSiLU(ch(256), ch(256), 3, 2, dt)
        self.n18 = C2f(ch(256) + ch(512), ch(512), c.n(3), False, dt)
        self.n19 = ConvBnSiLU(ch(512), ch(512), 3, 2, dt)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), c.n(3), False, dt)
        self.proto = Proto(c, ch(256))
        for lvl, cin in enumerate((ch(256), ch(512), ch(1024))):
            self.add_module(f"head{lvl}", DetectSegHead(c, cin))

    def forward(self, images):
        x = images.to(self.cfg.dtype)
        x = self.b2(self.b1(self.b0(x)))
        p3 = self.b4(self.b3(x))
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))
        n4 = self.n12(torch.cat([_upsample2(p5), p4], dim=1))
        n3 = self.n15(torch.cat([_upsample2(n4), p3], dim=1))
        n4b = self.n18(torch.cat([self.n16(n3), n4], dim=1))
        n5 = self.n21(torch.cat([self.n19(n4b), p5], dim=1))
        proto = self.proto(n3)
        levels = [getattr(self, f"head{lvl}")(f) for lvl, f in enumerate((n3, n4b, n5))]
        return {"levels": levels, "proto": proto.float()}


def init_yoloseg_(model: YoloSeg, generator: torch.Generator) -> YoloSeg:
    """Seeded random weights: conv kernels normal with variance 2/fan_in,
    biases 0, BatchNorm scale 1, bias 0, running mean 0, variance 1.

    flax's default init (variance 1/fan_in) lets the activations of this
    ~100-layer SiLU net shrink to ~1e-5, its mask logits to ~1e-8 and its
    boxes onto whole-pixel edges, so every mask pixel sits on the sigmoid's
    knife edge; at 2/fan_in the prototypes keep a scale of ~1e-2 and the
    masks cover a part of their boxes."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.dim() == 4:
                # ConvTranspose2d weight is (in, out, kh, kw): fan_in over dim 0
                fan_in = (p.shape[0] if name.endswith("upsample.weight")
                          else p.shape[1]) * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            elif name.endswith("bn.weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# ultralytics weights
# ---------------------------------------------------------------------------

# module-index layout of the ultralytics yolov8*-seg config (FastSAM uses it
# unchanged): backbone 0-9, neck 12/15/16/18/19/21, Segment head 22
_UL_NAMES = {0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5", 6: "b6",
             7: "b7", 8: "b8", 9: "b9", 12: "n12", 15: "n15", 16: "n16",
             18: "n18", 19: "n19", 21: "n21"}


def ultralytics_key(key: str):
    """An ultralytics yolov8-seg key ('model.{idx}.*') -> the port's name,
    or None for keys the port does not hold (num_batches_tracked)."""
    if key.endswith("num_batches_tracked"):
        return None
    k = key[6:] if key.startswith("model.") else key
    idx, rest = k.split(".", 1)
    if int(idx) == 22:
        m = re.match(r"(cv[234])\.(\d)\.(\d)\.(.*)", rest)
        if m:   # per-level head branches: cv2.{lvl}.{k}.* -> head{lvl}.cv2_{k}.*
            return f"head{m.group(2)}.{m.group(1)}_{m.group(3)}.{m.group(4)}"
        return rest   # proto.*
    return f"{_UL_NAMES[int(idx)]}." + re.sub(r"\bm\.(\d+)\.", r"m\1.", rest)


def convert_ultralytics_state_dict(sd, cfg: YoloSegConfig = None) -> Dict[str, torch.Tensor]:
    """ultralytics yolov8-seg 'model.{idx}.*' state dict (tensors or numpy
    arrays) -> the port's YoloSeg state dict. The layouts are the same
    (OIHW convolutions, ConvTranspose2d (in, out, kh, kw)); only names
    change."""
    out = {}
    for key, v in sd.items():
        name = ultralytics_key(key)
        if name is not None:
            out[name] = torch.as_tensor(np.asarray(
                v.detach().cpu() if hasattr(v, "detach") else v))
    return out


# ---------------------------------------------------------------------------
# decode + postprocess (batched, fixed shapes)
# ---------------------------------------------------------------------------

def dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*reg_max) -> (..., 4) expected ltrb distances (stride units)."""
    x = box_logits.reshape(box_logits.shape[:-1] + (4, reg_max)).float()
    p = torch.softmax(x, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(dim=-1)


def decode_predictions(outputs: dict, cfg: YoloSegConfig, img_hw: Tuple[int, int],
                       strides: Sequence[int] = (8, 16, 32), with_cls: bool = False):
    """Raw head outputs -> flat per-anchor (boxes xyxy (B, A, 4), scores
    (B, A), mask coeffs (B, A, nm)[, argmax class (B, A) when with_cls]),
    boxes in input-image pixels."""
    all_boxes, all_scores, all_mc, all_cls = [], [], [], []
    for (box, cls, mc), stride in zip(outputs["levels"], strides):
        B, _, h, w = box.shape

        def flat(t):  # (B, C, h, w) -> (B, h*w, C)
            return t.permute(0, 2, 3, 1).reshape(B, h * w, -1)

        ltrb = dfl_decode(flat(box), cfg.reg_max) * stride
        dev = box.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        cx, cy = cx.reshape(1, -1), cy.reshape(1, -1)
        boxes = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                             cx + ltrb[..., 2], cy + ltrb[..., 3]], dim=-1)
        probs = torch.sigmoid(flat(cls).float())
        all_boxes.append(boxes)
        all_scores.append(probs.max(dim=-1).values)   # class-agnostic
        all_mc.append(flat(mc).float())
        if with_cls:
            all_cls.append(torch.argmax(probs, dim=-1).to(torch.int32))
    res = (torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1),
           torch.cat(all_mc, dim=1))
    if with_cls:
        return res + (torch.cat(all_cls, dim=1),)
    return res


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, conf: float,
             iou_thresh: float, max_out: int):
    """Batched class-agnostic greedy NMS with a fixed output size.

    boxes (B, A, 4), scores (B, A) -> (idx (B, K), keep (B, K) bool).
    Greedy over the top K2 = 4*max_out candidates, taken by a stable
    descending sort (ties: lower anchor first, as lax.top_k). The greedy
    pass is a loop on the device with no host sync.
    """
    B, A, _ = boxes.shape
    K2 = min(4 * max_out, A)
    scores = torch.where(scores >= conf, scores, torch.zeros_like(scores))
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :K2], top_i[:, :K2]
    tb = torch.gather(boxes, 1, top_i[..., None].expand(B, K2, 4))

    area = (torch.clamp(tb[..., 2] - tb[..., 0], min=0)
            * torch.clamp(tb[..., 3] - tb[..., 1], min=0))
    lt = torch.maximum(tb[:, :, None, :2], tb[:, None, :, :2])
    rb = torch.minimum(tb[:, :, None, 2:], tb[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter, min=1e-9)
    later = torch.ones(K2, K2, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > iou_thresh) & later                  # (B, K2, K2)
    alive = top_s > 0
    for k in range(K2):
        # a candidate that is still alive suppresses the later ones it overlaps
        alive = alive & ~(suppress[:, k] & alive[:, k:k + 1])
    kept = alive
    # compact the first max_out kept entries
    order = torch.argsort((~kept).to(torch.int8), dim=-1, stable=True)[:, :max_out]
    return torch.gather(top_i, 1, order), torch.gather(kept, 1, order)


def mask_logits(proto: torch.Tensor, mask_coeffs: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """proto (B, nm, Hp, Wp) + coeffs (B, K, nm) -> (B, K, H, W) mask logits,
    bilinearly resized."""
    B, nm, Hp, Wp = proto.shape
    logits = torch.bmm(mask_coeffs, proto.reshape(B, nm, Hp * Wp)).reshape(B, -1, Hp, Wp)
    return resize_bilinear(logits, out_hw)


def assemble_masks(proto: torch.Tensor, mask_coeffs: torch.Tensor, boxes: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """proto (B, nm, Hp, Wp) + coeffs (B, K, nm) -> (B, K, H, W) bool masks
    cropped to their boxes (ultralytics process_mask semantics)."""
    H, W = out_hw
    m = mask_logits(proto, mask_coeffs, out_hw)
    dev = proto.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    inbox = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    # >= : the logits of a random net are ~1e-8 and the sigmoid rounds to
    # exactly 0.5 (ties are measure-zero with trained weights)
    return (torch.sigmoid(m) >= 0.5) & inbox


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, ...) gathered at idx (B, K) along A."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def select_proposals(out: dict, cfg: YoloSegConfig, img_hw, conf: float, iou: float,
                     max_masks: int):
    """Decode and NMS: (anchor index (B, K), boxes (B, K, 4), scores (B, K)
    zeroed where not kept, mask coeffs (B, K, nm), keep (B, K))."""
    boxes, scores, mcs = decode_predictions(out, cfg, img_hw)
    idx, keep = nms_topk(boxes, scores, conf, iou, max_masks)
    return idx, _take(boxes, idx), _take(scores, idx) * keep, _take(mcs, idx), keep


def segment_everything(model: YoloSeg, images: torch.Tensor, conf: float = 0.5,
                       iou: float = 0.9, max_masks: int = 64):
    """Batched inference: images (B, 3, H, W) in [0, 1] -> (masks (B, K, H,
    W) bool, boxes (B, K, 4), scores (B, K), valid (B, K)). FastSAM
    everything mode with the reference's conf/iou (fastsam_params.py
    conf=.5 iou=.9)."""
    H, W = images.shape[-2:]
    out = model(images)
    _, kb, ks, km, keep = select_proposals(out, model.cfg, (H, W), conf, iou, max_masks)
    masks = assemble_masks(out["proto"], km, kb, (H, W)) & keep[..., None, None]
    return masks, kb, ks, keep


def detect_labeled(model: YoloSeg, images: torch.Tensor, conf: float = 0.25,
                   iou: float = 0.45, max_out: int = 32):
    """Labeled detection: the YOLOv7 stand-in for the reference's
    ignore/keep label filtering (fastsam_wrapper.py:440-484), served by a
    YoloSeg detect head with nc > 1.

    images (B, 3, H, W) in [0, 1] -> (boxes (B, K, 4) xyxy pixels, cls (B, K)
    int32, scores (B, K), valid (B, K) bool).
    """
    H, W = images.shape[-2:]
    out = model(images)
    boxes, scores, _, cls = decode_predictions(out, model.cfg, (H, W), with_cls=True)
    idx, keep = nms_topk(boxes, scores, conf, iou, max_out)
    return _take(boxes, idx), _take(cls, idx), _take(scores, idx) * keep, keep
