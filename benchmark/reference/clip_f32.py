"""The plain reference of the front end's CLIP crop semantics (upstream
ROMAN's ``semantics: 'clip'``: the model loaded at fastsam_wrapper.py:181-183,
each kept mask's box crop embedded at :393-406), in float32 (TF32 off),
written from the published architecture in transformers'
``CLIPVisionModelWithProjection`` key layout, with no kernel, graph or
batching trick:

- a mask's box: upstream mask_bounding_box (fastsam_wrapper.py:577-600):
  the mask's height and width (from its extents), centred on the mean of
  its pixel indices (float64, as numpy's mean), each end truncated to an
  integer and clipped to the image; the ends are inclusive;
- the crop: the box's pixels stretched to img_size x img_size by the
  antialiased triangle kernel (a tent one pixel wide on half-pixel
  centres, widened by the box's side over img_size where it shrinks,
  normalized; an output pixel whose centre falls outside the image reads
  nothing);
- CLIP's normalization (OpenAI's mean and std);
- CLIP ViT-L/14's image tower: 14 px patches without bias, a class token
  and a learned 257-position embedding, the pre-LayerNorm, 24 pre-norm
  blocks (16 heads of 64, q scaled after its projection, quickGELU MLP of
  4096), the post-LayerNorm of the class token and the bias-free
  projection to 768; then a unit norm.

Departures from upstream, shared with the program:

- the crop is stretched to 224 x 224 by the triangle kernel; upstream's
  CLIP preprocess resizes the shorter side to 224 by bicubic
  interpolation and keeps the centre 224 x 224, so it drops the longer
  side's ends where the reference keeps them;
- upstream runs the tower in float16 (clip.load on a card); the program's
  products are bfloat16, the reference's float32;
- upstream encodes each mask that passed the filters by itself; the
  program encodes every proposal slot of a frame, the reference the slots
  it is compared on;
- the weights are random, drawn from the scene's seed in the upstream
  layout (draw_weights): no checkpoint is in the repository.

``Precision`` (frontend_f32's) says in what the arithmetic runs: ``F32``
is the reference, ``CONTROL`` the comparison's control (conv and linear
operands, q k^T and the probabilities times v in fp8 e4m3 with a
per-tensor scale, the rest in bfloat16).

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.frontend_f32 import F32, Precision

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# a second stream of the scene's seed, so the other nets' draws stay as
# they are without CLIP
STREAM = 0xC11F
# crops a forward holds at once (a ViT-L/14 layer's float32 logits: 135 MB)
CHUNK = 32


@dataclasses.dataclass(frozen=True)
class ClipArch:
    """CLIP ViT-L/14 (openai/clip-vit-large-patch14's vision config):
    1024 wide, 24 layers, 16 heads, MLP 4096, 14 px patches at 224 px, a
    768-d projection, LayerNorm eps 1e-5."""

    width: int = 1024
    depth: int = 24
    heads: int = 16
    patch: int = 14
    img_size: int = 224
    mlp: int = 4096
    proj_dim: int = 768
    ln_eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 1


ARCHS = {"clip-vit-l14": ClipArch(),
         "tiny": ClipArch(width=64, depth=2, heads=4, img_size=56, mlp=256, proj_dim=64)}


def clip_spec(a: ClipArch) -> dict:
    """{transformers CLIPVisionModelWithProjection key: shape}."""
    D, v = a.width, "vision_model."
    s = {v + "embeddings.class_embedding": (D,),
         v + "embeddings.patch_embedding.weight": (D, 3, a.patch, a.patch),
         v + "embeddings.position_embedding.weight": (a.tokens, D),
         v + "pre_layrnorm.weight": (D,), v + "pre_layrnorm.bias": (D,)}
    for i in range(a.depth):
        p = f"{v}encoder.layers.{i}"
        for nm in ("k", "v", "q", "out"):
            s[f"{p}.self_attn.{nm}_proj.weight"] = (D, D)
            s[f"{p}.self_attn.{nm}_proj.bias"] = (D,)
        s.update({f"{p}.layer_norm1.weight": (D,), f"{p}.layer_norm1.bias": (D,),
                  f"{p}.mlp.fc1.weight": (a.mlp, D), f"{p}.mlp.fc1.bias": (a.mlp,),
                  f"{p}.mlp.fc2.weight": (D, a.mlp), f"{p}.mlp.fc2.bias": (D,),
                  f"{p}.layer_norm2.weight": (D,), f"{p}.layer_norm2.bias": (D,)})
    s.update({v + "post_layernorm.weight": (D,), v + "post_layernorm.bias": (D,),
              "visual_projection.weight": (a.proj_dim, D)})
    return s


def _scale(key, shp):
    """(std, mean) of a tensor: kernels normal with variance 1 / fan_in,
    biases near 0, norms near 1, the class and position embeddings
    normal(0.02)."""
    if key.endswith(("class_embedding", "position_embedding.weight")):
        return 0.02, 0.0
    if "norm" in key and key.endswith("weight"):
        return 0.05, 1.0
    if key.endswith("bias"):
        return 0.02, 0.0
    return 1.0 / math.sqrt(math.prod(shp[1:])), 0.0


def draw_weights(seed: int, a: ClipArch, device) -> dict:
    """The tower's weights in the upstream layout, float32 on `device`, from
    one normal draw of a torch.Generator seeded there from (seed, STREAM)."""
    mixed = int(np.random.SeedSequence([int(seed) % (2**63), STREAM]).generate_state(
        1, np.uint64)[0]) % (2**63)
    gen = torch.Generator(device=device).manual_seed(mixed)
    spec = clip_spec(a)
    sizes = [math.prod(shp) for shp in spec.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (key, shp), n in zip(spec.items(), sizes):
        std, mean = _scale(key, shp)
        out[key] = flat[at:at + n].reshape(shp) * std + mean
        at += n
    return out


def boxes(masks: torch.Tensor) -> torch.Tensor:
    """mask_bounding_box of each mask (n, H, W) bool, nonempty -> (n, 4)
    int64 (x0, y0, x1, y1), ends inclusive."""
    _, H, W = masks.shape
    out = []
    for axis, size in ((-2, W), (-1, H)):  # columns (x), then rows (y)
        hit = masks.any(dim=axis)                                    # (n, size)
        idx = torch.arange(size, device=masks.device)
        lo = torch.where(hit, idx, size).min(-1).values
        hi = torch.where(hit, idx, -1).max(-1).values
        count = masks.sum(dim=axis).double()
        centre = (count * idx.double()).sum(-1) / count.sum(-1)
        half = torch.div(hi - lo + 1, 2, rounding_mode="floor").double()
        out.append((torch.floor((centre - half).clamp(min=0)).long(),
                    torch.floor((centre + half).clamp(max=size - 1)).long()))
    (x0, x1), (y0, y1) = out
    return torch.stack([x0, y0, x1, y1], -1)


def _tent(first: torch.Tensor, last: torch.Tensor, size: int, out: int) -> torch.Tensor:
    """(n, out, size) weights that stretch pixels first..last (inclusive)
    of a line of `size` pixels to `out` pixels: the triangle kernel on
    half-pixel centres, widened by (last - first + 1) / out where that is
    above 1, each row normalized; rows whose centre falls outside the
    line are 0."""
    n_in = (last - first + 1).double()[:, None, None]
    o = torch.arange(out, device=first.device, dtype=torch.float64)[None, :, None]
    j = torch.arange(size, device=first.device, dtype=torch.float64)[None, None, :]
    src = (o + 0.5) * n_in / out + first.double()[:, None, None] - 0.5    # (n, out, 1)
    width = (n_in / out).clamp(min=1.0)
    w = (1.0 - (src - j).abs() / width).clamp(min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 0, w / total.clamp(min=1e-300), torch.zeros_like(w))
    inside = (src >= -0.5) & (src <= size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w)).float()


def crops(image: torch.Tensor, box: torch.Tensor, size: int) -> torch.Tensor:
    """The boxes (n, 4) of one image (3, H, W) stretched to (n, 3, size,
    size), normalized by CLIP's mean and std."""
    _, H, W = image.shape
    wy = _tent(box[:, 1], box[:, 3], H, size)                            # (n, S, H)
    wx = _tent(box[:, 0], box[:, 2], W, size)                            # (n, S, W)
    x = torch.einsum("nsh,chw,ntw->ncst", wy, image, wx)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def encode(w: dict, a: ClipArch, x: torch.Tensor, p: Precision = F32) -> torch.Tensor:
    """Normalized crops (n, 3, S, S) -> projected class embeddings (n,
    proj_dim) (transformers' image_embeds)."""
    D, nh, v = a.width, a.heads, "vision_model."
    hd = D // nh
    n = x.shape[0]

    def lin(h, name, bias=True):
        y = p.op(h) @ p.op(w[f"{name}.weight"]).t()
        return p.out(y + w[f"{name}.bias"] if bias else y)

    def ln(h, name):
        return p.out(F.layer_norm(h, (D,), w[f"{name}.weight"], w[f"{name}.bias"], a.ln_eps))

    h = p.out(F.conv2d(p.op(x), p.op(w[v + "embeddings.patch_embedding.weight"]),
                       stride=a.patch))
    h = h.flatten(2).transpose(1, 2)
    cls = w[v + "embeddings.class_embedding"].expand(n, 1, D)
    h = p.out(torch.cat([cls, h], 1) + w[v + "embeddings.position_embedding.weight"])
    h = ln(h, v + "pre_layrnorm")
    for i in range(a.depth):
        pre = f"{v}encoder.layers.{i}"
        t = ln(h, f"{pre}.layer_norm1")

        def heads(y):
            return y.reshape(n, -1, nh, hd).transpose(1, 2)

        q = heads(p.out(lin(t, f"{pre}.self_attn.q_proj") * hd ** -0.5))
        k, val = (heads(lin(t, f"{pre}.self_attn.{nm}_proj")) for nm in ("k", "v"))
        att = p.out(torch.softmax(p.out(p.op(q) @ p.op(k).transpose(-1, -2)), -1))
        o = p.out(p.op(att) @ p.op(val)).transpose(1, 2).reshape(n, -1, D)
        h = p.out(h + lin(o, f"{pre}.self_attn.out_proj"))
        t = lin(ln(h, f"{pre}.layer_norm2"), f"{pre}.mlp.fc1")
        t = p.out(t * torch.sigmoid(1.702 * t))
        h = p.out(h + lin(t, f"{pre}.mlp.fc2"))
    pooled = ln(h[:, 0], v + "post_layernorm")
    return lin(pooled, "visual_projection", bias=False)


def embeddings(w: dict, a: ClipArch, images: torch.Tensor, masks: torch.Tensor, slots,
               p: Precision = F32) -> torch.Tensor:
    """Unit embeddings (n, proj_dim) of the masks at `slots` ((frame, slot)
    index arrays of n > 0 nonempty masks): images (B, 3, H, W) in [0, 1],
    masks (B, K, H, W) bool. Computed CHUNK crops at a time."""
    fi, ki = (torch.as_tensor(np.asarray(s), device=masks.device, dtype=torch.long)
              for s in slots)
    out = []
    for s in range(0, len(fi), CHUNK):
        f, k = fi[s:s + CHUNK], ki[s:s + CHUNK]
        box = boxes(masks[f, k])
        x = torch.cat([crops(images[i], box[f == i], a.img_size) for i in torch.unique(f)])
        # torch.unique sorts, so the crops come frame by frame: put them back
        order = torch.cat([torch.nonzero(f == i)[:, 0] for i in torch.unique(f)])
        e = torch.empty(len(f), a.proj_dim, device=masks.device)
        e[order] = encode(w, a, p.out(x), p)
        out.append(e / e.norm(dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.cat(out)
