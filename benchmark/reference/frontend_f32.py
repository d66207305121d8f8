"""The plain reference of the demo's perception front end, in float32 (TF32
off), written from the published architectures in their upstream weight
layouts, with no kernel, graph or batching trick:

- FastSAM-x: a YOLOv8x-seg (ultralytics yolov8-seg.yaml at width 1.25,
  depth 1.0, max_channels 512; keys ``model.{idx}.*``): Conv-BN-SiLU, C2f,
  SPPF, the PAN neck, the Segment head (DFL box, class and 32 mask
  coefficient branches a level) and the prototype net;
- DINOv2-base (transformers ``Dinov2Model`` keys): 14 px patches, a learned
  37 x 37 position embedding resized to the frame's token grid, 12 pre-norm
  blocks with LayerScale and exact GELU, the final LayerNorm;
- the front end's arithmetic around them, as the configuration states it:
  images resized to the nets' inputs by jax.image.resize's antialiased
  bilinear rule (a stretch, not ultralytics' letterbox; the position
  embedding is resized the same way, where upstream DINOv2 uses bicubic),
  masks assembled at a proposal's anchor, mask-weighted patch pooling,
  GeM frame descriptors, and depth lifting (erosion, stride, max_depth,
  the capped point selection, the voxel means, the plane filter).

``Precision`` says in what the arithmetic runs. ``F32`` is the reference.
``CONTROL`` is the control of the comparison: convolution and linear
operands in fp8 e4m3 (a per-tensor scale to the format's range), the
products accumulated in float32 and rounded to bfloat16, and every other
step (norms, softmax, activations, mask assembly, lifting) in bfloat16.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# architecture sizes (published)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegArch:
    """yolov8-seg scaling: FastSAM-x is width 1.25, depth 1.0, max 512."""

    width: float = 1.25
    depth: float = 1.0
    max_channels: int = 512
    nc: int = 1
    nm: int = 32
    reg_max: int = 16

    def ch(self, c: int) -> int:
        return int(min(c, self.max_channels) * self.width)

    def n(self, n: int) -> int:
        return max(round(n * self.depth), 1)


@dataclasses.dataclass(frozen=True)
class VitArch:
    """DINOv2: base is 768 wide, 12 layers, 12 heads, 14 px patches, 518 px
    pretraining (a 37 x 37 position grid)."""

    width: int = 768
    depth: int = 12
    heads: int = 12
    patch: int = 14
    img_size: int = 518
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


SEG_ARCHS = {"fastsam-x": SegArch(),
             "tiny": SegArch(width=0.125, depth=0.33, nm=8)}
VIT_ARCHS = {"dinov2-base": VitArch(),
             "tiny": VitArch(width=64, depth=2, heads=4, img_size=84)}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-3
BOX_BIN_SLOPE = 0.35
STRIDES = (8, 16, 32)


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Precision:
    operand: str = "f32"     # conv and linear operands: "f32" or "fp8"
    act: str = "f32"         # everything else: "f32" or "bf16"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """A conv or linear operand as the precision holds it (float32
        values)."""
        if self.operand == "f32":
            return x
        amax = x.abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def out(self, x: torch.Tensor) -> torch.Tensor:
        """A result rounded to the activations' precision."""
        if self.act == "f32":
            return x
        return x.to(torch.bfloat16).to(torch.float32)


F32 = Precision()
CONTROL = Precision(operand="fp8", act="bf16")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, for the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ---------------------------------------------------------------------------
# weight layouts (names and shapes of the upstream checkpoints)
# ---------------------------------------------------------------------------

def _conv_spec(out: dict, name: str, cin: int, cout: int, k: int):
    out[f"{name}.conv.weight"] = (cout, cin, k, k)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.bn.{leaf}"] = (cout,)


def _c2f_spec(out, name, cin, cout, n):
    c = cout // 2
    _conv_spec(out, f"{name}.cv1", cin, 2 * c, 1)
    _conv_spec(out, f"{name}.cv2", (2 + n) * c, cout, 1)
    for j in range(n):
        _conv_spec(out, f"{name}.m.{j}.cv1", c, c, 3)
        _conv_spec(out, f"{name}.m.{j}.cv2", c, c, 3)


def seg_widths(a: SegArch) -> dict:
    ch = a.ch
    p3 = ch(256)
    return dict(box=max(16, p3 // 4, 4 * a.reg_max), cls=max(p3, min(a.nc, 100)),
                coef=max(p3 // 4, a.nm), proto=max(p3, a.nm),
                levels=(ch(256), ch(512), ch(1024)))


def seg_spec(a: SegArch) -> dict:
    """{ultralytics key: shape} of a yolov8-seg at scaling `a`."""
    ch, n, s = a.ch, a.n, {}
    _conv_spec(s, "model.0", 3, ch(64), 3)
    _conv_spec(s, "model.1", ch(64), ch(128), 3)
    _c2f_spec(s, "model.2", ch(128), ch(128), n(3))
    _conv_spec(s, "model.3", ch(128), ch(256), 3)
    _c2f_spec(s, "model.4", ch(256), ch(256), n(6))
    _conv_spec(s, "model.5", ch(256), ch(512), 3)
    _c2f_spec(s, "model.6", ch(512), ch(512), n(6))
    _conv_spec(s, "model.7", ch(512), ch(1024), 3)
    _c2f_spec(s, "model.8", ch(1024), ch(1024), n(3))
    _conv_spec(s, "model.9.cv1", ch(1024), ch(1024) // 2, 1)
    _conv_spec(s, "model.9.cv2", 2 * ch(1024), ch(1024), 1)
    _c2f_spec(s, "model.12", ch(1024) + ch(512), ch(512), n(3))
    _c2f_spec(s, "model.15", ch(512) + ch(256), ch(256), n(3))
    _conv_spec(s, "model.16", ch(256), ch(256), 3)
    _c2f_spec(s, "model.18", ch(256) + ch(512), ch(512), n(3))
    _conv_spec(s, "model.19", ch(512), ch(512), 3)
    _c2f_spec(s, "model.21", ch(512) + ch(1024), ch(1024), n(3))
    w = seg_widths(a)
    for lvl, cin in enumerate(w["levels"]):
        for br, hid, cout in (("cv2", w["box"], 4 * a.reg_max), ("cv3", w["cls"], a.nc),
                              ("cv4", w["coef"], a.nm)):
            _conv_spec(s, f"model.22.{br}.{lvl}.0", cin, hid, 3)
            _conv_spec(s, f"model.22.{br}.{lvl}.1", hid, hid, 3)
            s[f"model.22.{br}.{lvl}.2.weight"] = (cout, hid, 1, 1)
            s[f"model.22.{br}.{lvl}.2.bias"] = (cout,)
    cp = w["proto"]
    _conv_spec(s, "model.22.proto.cv1", ch(256), cp, 3)
    s["model.22.proto.upsample.weight"] = (cp, cp, 2, 2)
    s["model.22.proto.upsample.bias"] = (cp,)
    _conv_spec(s, "model.22.proto.cv2", cp, cp, 3)
    _conv_spec(s, "model.22.proto.cv3", cp, a.nm, 1)
    return s


def vit_spec(a: VitArch) -> dict:
    """{transformers Dinov2Model key: shape}."""
    D, H = a.width, int(a.width * a.mlp_ratio)
    s = {"embeddings.cls_token": (1, 1, D),
         "embeddings.position_embeddings": (1, a.grid * a.grid + 1, D),
         "embeddings.patch_embeddings.projection.weight": (D, 3, a.patch, a.patch),
         "embeddings.patch_embeddings.projection.bias": (D,),
         "layernorm.weight": (D,), "layernorm.bias": (D,)}
    for i in range(a.depth):
        p = f"encoder.layer.{i}"
        for nm in ("query", "key", "value"):
            s[f"{p}.attention.attention.{nm}.weight"] = (D, D)
            s[f"{p}.attention.attention.{nm}.bias"] = (D,)
        s.update({f"{p}.norm1.weight": (D,), f"{p}.norm1.bias": (D,),
                  f"{p}.attention.output.dense.weight": (D, D),
                  f"{p}.attention.output.dense.bias": (D,),
                  f"{p}.layer_scale1.lambda1": (D,),
                  f"{p}.norm2.weight": (D,), f"{p}.norm2.bias": (D,),
                  f"{p}.mlp.fc1.weight": (H, D), f"{p}.mlp.fc1.bias": (H,),
                  f"{p}.mlp.fc2.weight": (D, H), f"{p}.mlp.fc2.bias": (D,),
                  f"{p}.layer_scale2.lambda1": (D,)})
    return s


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------

def _draw(spec: dict, scale_of, generator: torch.Generator, device) -> dict:
    """One normal draw for the whole net, cut into its tensors and scaled:
    scale_of(key, shape) -> (std, mean)."""
    sizes = [math.prod(shp) for shp in spec.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (key, shp), n in zip(spec.items(), sizes):
        std, mean = scale_of(key, shp)
        out[key] = (flat[at:at + n].reshape(shp) * std + mean) if std else \
            torch.full(shp, float(mean), device=device)
        at += n
    return out


def _seg_scale(key, shp):
    """Kernels normal with variance 2 / fan_in; the box branch's last
    kernel 3x wider, so the DFL bins are peaked and the boxes vary in
    size; BatchNorm statistics and affine drawn near identity."""
    if key.endswith("running_var"):
        return 0.1, 1.0
    if key.endswith("bn.weight"):
        return 0.1, 1.0
    if key.endswith(("running_mean", "bn.bias")):
        return 0.05, 0.0
    if key.endswith("bias"):
        return 0.1, 0.0
    fan_in = (shp[0] if "upsample" in key else shp[1]) * shp[2] * shp[3]
    std = math.sqrt(2.0 / fan_in)
    if ".cv2." in key and key.endswith(".2.weight"):
        std *= 3.0
    return std, 0.0


def _vit_scale(key, shp):
    """Kernels normal with variance 1 / fan_in, biases and norms near 0
    and 1, the position embedding and class token normal(0.02), LayerScale
    about 0.1 (trained DINOv2 scales are of that order)."""
    if key.endswith(("position_embeddings", "cls_token")):
        return 0.02, 0.0
    if key.endswith("lambda1"):
        return 0.02, 0.1
    if "norm" in key and key.endswith("weight"):
        return 0.05, 1.0
    if key.endswith("bias"):
        return 0.02, 0.0
    return 1.0 / math.sqrt(math.prod(shp[1:])), 0.0


def draw_weights(seed: int, seg_arch: SegArch, vit_arch: VitArch, device,
                 calib: torch.Tensor) -> tuple:
    """(FastSAM weights, DINOv2 weights) in their upstream layouts, float32
    on `device`, from one torch.Generator seeded with `seed` there, the
    segmentation heads' last biases set on `calib` (frames (B, 3, h, w) in
    [0, 1] at the net's input size; see _center_heads)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    seg = _draw(seg_spec(seg_arch), _seg_scale, gen, device)
    seg = {k: (v.abs() if k.endswith("running_var") else v) for k, v in seg.items()}
    vit = _draw(vit_spec(vit_arch), _vit_scale, gen, device)
    with torch.no_grad(), no_tf32():
        _center_heads(seg, seg_arch, calib)
    return seg, vit


def _center_heads(seg: dict, a: SegArch, calib: torch.Tensor):
    """Random heads score every anchor of a seed alike (the features' mean
    passes through their last kernels), so that one seed keeps no proposal
    and the next keeps all. So each level's last biases are set on the
    calibration frames: the class logit's median over the anchors to 0
    (half the anchors pass the 0.5 score), each DFL bin's mean to
    -BOX_BIN_SLOPE times its index (a side's expected distance is a few
    bins, so proposals run from a tenth of the input to most of it across
    the strides), and each mask coefficient's mean to 0."""
    for lvl in range(len(STRIDES)):
        for br in ("cv2", "cv3", "cv4"):
            seg[f"model.22.{br}.{lvl}.2.bias"].zero_()
    levels, _ = _Seg(seg, a, F32).forward(calib)
    slope = -BOX_BIN_SLOPE * torch.arange(a.reg_max, device=calib.device, dtype=torch.float32)
    for lvl, (box, cls, coef) in enumerate(levels):
        seg[f"model.22.cv2.{lvl}.2.bias"] = slope.repeat(4) - box.mean((0, 2, 3))
        seg[f"model.22.cv3.{lvl}.2.bias"] = -cls.transpose(0, 1).flatten(1).median(1).values
        seg[f"model.22.cv4.{lvl}.2.bias"] = -coef.mean((0, 2, 3))


def calib_frames(images_u8, hw, device) -> torch.Tensor:
    """The calibration frames of draw_weights: uint8 frames (B, H, W, 3)
    resized to the net's input size."""
    x = torch.as_tensor(np.ascontiguousarray(images_u8), device=device)
    return resize_bilinear(x.permute(0, 3, 1, 2).float() / 255.0, hw)


# ---------------------------------------------------------------------------
# resampling (jax.image.resize semantics, as the configuration states)
# ---------------------------------------------------------------------------

def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source pixel of each output pixel: floor((i + 0.5) * in / out), the
    ratio formed in float32 as f32(1 / out) * in."""
    one = torch.ones((), dtype=torch.float32, device=device)
    ratio = (one / n_out) * n_in
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * ratio).long()


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    H, W = x.shape[-2:]
    if hw[0] != H:
        x = x.index_select(-2, nearest_index(H, hw[0], x.device))
    if hw[1] != W:
        x = x.index_select(-1, nearest_index(W, hw[1], x.device))
    return x


# ---------------------------------------------------------------------------
# FastSAM-x (YOLOv8x-seg)
# ---------------------------------------------------------------------------

class _Seg:
    def __init__(self, w: dict, a: SegArch, p: Precision):
        self.w, self.a, self.p = w, a, p

    def conv(self, x, name, stride=1):
        w = self.w[f"{name}.conv.weight"]
        y = self.p.out(F.conv2d(self.p.op(x), self.p.op(w), stride=stride,
                                padding=w.shape[-1] // 2))
        mean, var = self.w[f"{name}.bn.running_mean"], self.w[f"{name}.bn.running_var"]
        g, b = self.w[f"{name}.bn.weight"], self.w[f"{name}.bn.bias"]
        y = self.p.out((y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
                       * g[:, None, None] + b[:, None, None])
        return self.p.out(F.silu(y))

    def plain(self, x, name):
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        return self.p.out(F.conv2d(self.p.op(x), self.p.op(w)) + b[:, None, None])

    def c2f(self, x, name, n, shortcut):
        y = self.conv(x, f"{name}.cv1")
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for j in range(n):
            h = self.conv(self.conv(parts[-1], f"{name}.m.{j}.cv1"), f"{name}.m.{j}.cv2")
            parts.append(self.p.out(parts[-1] + h) if shortcut else h)
        return self.conv(torch.cat(parts, 1), f"{name}.cv2")

    def sppf(self, x, name):
        x = self.conv(x, f"{name}.cv1")
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.conv(torch.cat([x, p1, p2, p3], 1), f"{name}.cv2")

    def forward(self, img):
        n = self.a.n
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        x = self.conv(self.conv(img, "model.0", 2), "model.1", 2)
        x = self.c2f(x, "model.2", n(3), True)
        p3 = self.c2f(self.conv(x, "model.3", 2), "model.4", n(6), True)
        p4 = self.c2f(self.conv(p3, "model.5", 2), "model.6", n(6), True)
        p5 = self.sppf(self.c2f(self.conv(p4, "model.7", 2), "model.8", n(3), True), "model.9")
        h12 = self.c2f(torch.cat([up(p5), p4], 1), "model.12", n(3), False)
        h15 = self.c2f(torch.cat([up(h12), p3], 1), "model.15", n(3), False)
        h18 = self.c2f(torch.cat([self.conv(h15, "model.16", 2), h12], 1), "model.18", n(3), False)
        h21 = self.c2f(torch.cat([self.conv(h18, "model.19", 2), p5], 1), "model.21", n(3), False)
        levels = []
        for lvl, f in enumerate((h15, h18, h21)):
            outs = []
            for br in ("cv2", "cv3", "cv4"):
                h = self.conv(self.conv(f, f"model.22.{br}.{lvl}.0"), f"model.22.{br}.{lvl}.1")
                outs.append(self.plain(h, f"model.22.{br}.{lvl}.2"))
            levels.append(outs)
        pr = self.conv(h15, "model.22.proto.cv1")
        wu, bu = self.w["model.22.proto.upsample.weight"], self.w["model.22.proto.upsample.bias"]
        pr = self.p.out(F.conv_transpose2d(self.p.op(pr), self.p.op(wu), stride=2)
                        + bu[:, None, None])
        proto = self.conv(self.conv(pr, "model.22.proto.cv2"), "model.22.proto.cv3")
        return levels, proto


def seg_forward(w: dict, a: SegArch, images: torch.Tensor, p: Precision = F32) -> dict:
    """images (B, 3, h, w) in [0, 1] at the net's input size -> {"box"
    (B, A, 4) xyxy pixels, "score" (B, A), "coef" (B, A, nm), "proto" (B, nm,
    h/4, w/4)}, anchors flattened level by level, row-major."""
    levels, proto = _Seg(w, a, p).forward(p.out(images))
    boxes, scores, coefs = [], [], []
    bins = torch.arange(a.reg_max, dtype=torch.float32, device=images.device)
    for (box, cls, coef), stride in zip(levels, STRIDES):
        B, _, h, wd = box.shape
        flat = lambda t: t.permute(0, 2, 3, 1).reshape(B, h * wd, -1)  # noqa: E731
        dist = p.out(torch.softmax(flat(box).reshape(B, h * wd, 4, a.reg_max), -1))
        ltrb = p.out((dist * bins).sum(-1)) * stride
        ys = (torch.arange(h, dtype=torch.float32, device=box.device) + 0.5) * stride
        xs = (torch.arange(wd, dtype=torch.float32, device=box.device) + 0.5) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        cx, cy = cx.reshape(1, -1), cy.reshape(1, -1)
        boxes.append(p.out(torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                                        cx + ltrb[..., 2], cy + ltrb[..., 3]], -1)))
        scores.append(torch.sigmoid(flat(cls)).amax(-1))
        coefs.append(flat(coef))
    return dict(box=torch.cat(boxes, 1), score=torch.cat(scores, 1), coef=torch.cat(coefs, 1),
                proto=proto)


def mask_logits(seg: dict, anchors: torch.Tensor, hw, p: Precision = F32) -> tuple:
    """The mask logits (B, K, h, w) at the net's input size, the boxes (B,
    K, 4) of the proposals at `anchors` (B, K), and each logit's scale: the
    coefficients times the prototypes, bilinearly resized (upstream
    process_mask), and the same of their magnitudes (the sum of the terms'
    magnitudes, which bounds the logit's rounding)."""
    idx = anchors.long()
    coef = torch.gather(seg["coef"], 1, idx[..., None].expand(*idx.shape, seg["coef"].shape[-1]))
    box = torch.gather(seg["box"], 1, idx[..., None].expand(*idx.shape, 4))
    B, nm, hp, wp = seg["proto"].shape
    proto = seg["proto"].reshape(B, nm, hp * wp)
    lg = p.out(torch.bmm(p.op(coef), p.op(proto)))
    lg = p.out(resize_bilinear(lg.reshape(B, -1, hp, wp), hw))
    scale = resize_bilinear(torch.bmm(coef.abs(), proto.abs()).reshape(B, -1, hp, wp), hw)
    return lg, box, scale


def masks_from_logits(logits: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """sigmoid >= 0.5 inside the box (pixel indices x1 <= x <= x2)."""
    H, W = logits.shape[-2:]
    ys = torch.arange(H, dtype=torch.float32, device=logits.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=logits.device)[None, :]
    x1, y1, x2, y2 = (box[..., i, None, None] for i in range(4))
    inbox = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    return (logits >= 0) & inbox


def box_edge_distance(box: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, K, H, W): each pixel's distance, in pixels, from the nearest
    edge line of its proposal's box."""
    ys = torch.arange(H, dtype=torch.float32, device=box.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=box.device)[None, :]
    x1, y1, x2, y2 = (box[..., i, None, None] for i in range(4))
    dx = torch.minimum((xs - x1).abs(), (xs - x2).abs())
    dy = torch.minimum((ys - y1).abs(), (ys - y2).abs())
    return torch.minimum(dx, dy)


# ---------------------------------------------------------------------------
# DINOv2-base
# ---------------------------------------------------------------------------

def vit_forward(w: dict, a: VitArch, images: torch.Tensor, p: Precision = F32) -> torch.Tensor:
    """Normalized images (B, 3, H, W), H and W multiples of the patch ->
    patch tokens (B, H/14, W/14, D) after the final LayerNorm."""
    D, nh = a.width, a.heads
    hd = D // nh
    B, _, H, W = images.shape
    gh, gw = H // a.patch, W // a.patch

    def lin(x, name):
        return p.out(p.op(x) @ p.op(w[f"{name}.weight"]).t() + w[f"{name}.bias"])

    def ln(x, name):
        return p.out(F.layer_norm(x, (D,), w[f"{name}.weight"], w[f"{name}.bias"], a.ln_eps))

    x = F.conv2d(p.op(images), p.op(w["embeddings.patch_embeddings.projection.weight"]),
                 stride=a.patch)
    x = p.out(x + w["embeddings.patch_embeddings.projection.bias"][:, None, None])
    x = x.flatten(2).transpose(1, 2)
    pos = w["embeddings.position_embeddings"]
    grid = pos[:, 1:].reshape(1, a.grid, a.grid, D).permute(0, 3, 1, 2)
    grid = resize_bilinear(grid, (gh, gw)).flatten(2).transpose(1, 2)
    x = torch.cat([w["embeddings.cls_token"].expand(B, 1, D), x], 1)
    x = p.out(x + torch.cat([pos[:, :1], grid], 1))
    for i in range(a.depth):
        pre = f"encoder.layer.{i}"
        h = ln(x, f"{pre}.norm1")
        q, k, v = (lin(h, f"{pre}.attention.attention.{n}").reshape(B, -1, nh, hd).transpose(1, 2)
                   for n in ("query", "key", "value"))
        att = p.out(torch.softmax(p.out((p.op(q) @ p.op(k).transpose(-1, -2)) / math.sqrt(hd)), -1))
        o = p.out(p.op(att) @ p.op(v)).transpose(1, 2).reshape(B, -1, D)
        o = lin(o, f"{pre}.attention.output.dense")
        x = p.out(x + o * w[f"{pre}.layer_scale1.lambda1"])
        h = p.out(F.gelu(lin(ln(x, f"{pre}.norm2"), f"{pre}.mlp.fc1")))
        x = p.out(x + lin(h, f"{pre}.mlp.fc2") * w[f"{pre}.layer_scale2.lambda1"])
    x = ln(x, "layernorm")
    return x[:, 1:].reshape(B, gh, gw, D)


def vit_input(images: torch.Tensor, patch: int) -> torch.Tensor:
    """Frames (B, 3, H, W) in [0, 1] -> the ViT's normalized input, resized
    to the largest multiple of the patch on each side."""
    H, W = images.shape[-2:]
    x = resize_bilinear(images, ((H // patch) * patch, (W // patch) * patch))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def pool_masks(patches: torch.Tensor, masks: torch.Tensor, patch: int,
               p: Precision = F32) -> torch.Tensor:
    """Mask-weighted patch pooling (the mean per-pixel DINO feature of the
    mask, upstream fastsam_wrapper.py:407-414, on the patch grid): masks
    (B, K, H, W) bool at frame size -> unit embeddings (B, K, D)."""
    B, gh, gw, D = patches.shape
    mg = resize_nearest(masks.float(), (gh * patch, gw * patch))
    wgt = F.avg_pool2d(mg, patch).reshape(B, masks.shape[1], gh * gw)
    emb = p.out(torch.bmm(p.op(wgt), p.op(patches.reshape(B, gh * gw, D))))
    emb = emb / wgt.sum(-1, keepdim=True).clamp(min=1e-9)
    return p.out(emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-9))


def gem_descriptor(patches: torch.Tensor, p: Precision = F32, gem_p: float = 3.0) -> torch.Tensor:
    """Signed generalized mean (p = 3) over the patch grid, L2-normalized
    (upstream fastsam_wrapper.py:650-666, 'dino-gem')."""
    flat = patches.reshape(patches.shape[0], -1, patches.shape[-1])
    cubed = p.out((flat ** gem_p).mean(1))
    d = torch.sign(cubed) * cubed.abs().clamp(min=1e-12) ** (1.0 / gem_p)
    return p.out(d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12))


# ---------------------------------------------------------------------------
# mask filters and lifting
# ---------------------------------------------------------------------------

def ellipse_footprint(ksize: int) -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE element: per row, a half-width of
    round(r * sqrt(1 - dy^2 / r^2))."""
    r = ksize // 2
    fp = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        dx = int(np.rint(r * np.sqrt(max(r * r - dy * dy, 0) / max(r * r, 1))))
        fp[i, r - dx:r + dx + 1] = True
    return fp


def erode_strided(masks: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Binary erosion by the ellipse (the border counts as set), kept at
    every stride-th row and column."""
    B, K, H, W = masks.shape
    fp = torch.as_tensor(ellipse_footprint(size), device=masks.device)
    e = size // 2
    x = F.pad(masks.reshape(B * K, 1, H, W).float(), (e, e, e, e), value=1.0)
    hits = F.conv2d(x, fp.float()[None, None], stride=stride)
    return (hits >= fp.sum().item() - 0.5).reshape(B, K, hits.shape[-2], hits.shape[-1])


def lift_points(depth: torch.Tensor, K: np.ndarray, stride: int,
                p: Precision = F32) -> torch.Tensor:
    """Depth (B, H, W) m -> camera points (B, H/s, W/s, 3) at every
    stride-th pixel: x = (u - cx) * f32(1 / fx) * z, likewise y."""
    B, H, W = depth.shape
    d = depth[:, ::stride, ::stride]
    v, u = torch.meshgrid(torch.arange(0, H, stride, dtype=torch.float32, device=depth.device),
                          torch.arange(0, W, stride, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    inv_fx = float(np.float32(1.0) / np.float32(K[0, 0]))
    inv_fy = float(np.float32(1.0) / np.float32(K[1, 1]))
    x = p.out(p.out((u - float(np.float32(K[0, 2]))) * inv_fx) * d)
    y = p.out(p.out((v - float(np.float32(K[1, 2]))) * inv_fy) * d)
    return torch.stack([x, y, p.out(d)], -1)


def pixel_rank(n: int, device) -> torch.Tensor:
    """The order in which a mask's lifted pixels are kept when it has more
    than the cap: by 48271 * i mod 65536, highest first (a fixed, spread
    sample of the strided pixel grid)."""
    return (torch.arange(n, device=device) * 48271) % 65536


def voxel_means(points: torch.Tensor, valid: torch.Tensor, voxel: float,
                p: Precision = F32):
    """The mean of each occupied voxel's points (voxels floor(x * f32(1 /
    voxel))) of one mask: -> (means (m, 3), counts (m,))."""
    pts = points[valid]
    if len(pts) == 0:
        return pts, torch.zeros(0, device=points.device)
    inv = float(np.float32(1.0) / np.float32(voxel))
    keys = torch.floor(pts * inv).long()
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    sums = torch.zeros(len(uniq), 3, device=pts.device).index_add_(0, inverse, pts)
    cnt = torch.zeros(len(uniq), device=pts.device).index_add_(
        0, inverse, torch.ones_like(pts[:, 0]))
    return p.out(sums / cnt[:, None]), cnt


def obb_extent(points: torch.Tensor) -> torch.Tensor:
    """Extents of the PCA-oriented box of (n, 3) points, in float64,
    largest axis first; zeros below 5 points."""
    if len(points) < 5:
        return torch.zeros(3, dtype=torch.float64, device=points.device)
    x = points.double()
    mu = x.mean(0)
    cov = (x - mu).T @ (x - mu) / len(x)
    _, vecs = torch.linalg.eigh(cov)
    proj = (x - mu) @ vecs.flip(-1)
    return proj.max(0).values - proj.min(0).values
