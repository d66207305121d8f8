"""Vision Transformer backbone shared by the DINOv2 and CLIP image
encoders: a port of roman_tpu/perception/vit.py as torch modules.

One configurable encoder covers both families:
- DINOv2: conv patch embed, learned pos embed (+cls), pre-norm blocks with
  LayerScale, GELU MLP, final LayerNorm; outputs cls + patch tokens.
- CLIP vision: conv patch embed (no bias), cls token, pre-LN transformer
  with quickGELU, post-LN + linear projection.

Numerics follow the flax modules. With ``dtype=torch.bfloat16`` every
product takes bf16 operands and returns bf16 (a linear layer rounds its
product, then its bias add); layer norms, the softmax and the residual
stream are float32 (LayerScale multiplies by a float32 gamma, so the
stream is float32 from the first block on). Attention logits are not
rounded to bf16: q (pre-scaled in bf16) and k are multiplied in float32,
which is exact for bf16 operands with TF32 off, as the flax module's
``preferred_element_type=float32`` product is. Module and parameter names
are the flax ones (``block{i}.attn.qkv``), so ``roman_tpu_torch.convert``
carries flax variables across by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    width: int = 768
    depth: int = 12
    heads: int = 12
    patch: int = 14
    img_size: int = 518
    mlp_ratio: float = 4.0
    layerscale: bool = True         # DINOv2 LayerScale
    quick_gelu: bool = False        # CLIP uses x*sigmoid(1.702x)
    pre_ln: bool = False            # CLIP applies LN before the blocks
    proj_dim: Optional[int] = None  # CLIP output projection
    patch_bias: bool = True
    ln_eps: float = 1e-6            # CLIP uses 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


class Linear(nn.Linear):
    """flax Dense(dtype=dtype): operands cast to dtype, the product rounded
    to dtype, then the bias added in dtype."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y + self.bias.to(dt) if self.bias is not None else y


def _const(x: torch.Tensor, v: float) -> float:
    """v rounded to x's dtype, as JAX rounds a Python scalar that meets an
    array of that dtype."""
    return float(torch.tensor(v, dtype=x.dtype))


def _gelu(x, quick: bool):
    """jax.nn.gelu(approximate=False) (0.5 x erfc(-x sqrt(1/2))) or CLIP's
    quickGELU (x sigmoid(1.702 x)) as a fused program computes them: in
    float32 with the constants rounded to x's dtype, rounded to it once."""
    xf = x.float()
    if quick:
        y = torch.sigmoid(xf * _const(x, 1.702)) * xf
    else:
        y = 0.5 * xf * torch.special.erfc(-xf * _const(x, math.sqrt(0.5)))
    return y.to(x.dtype)


def _layer_norm(norm: nn.LayerNorm, x):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.quick = cfg.quick_gelu
        self.fc1 = Linear(cfg.width, hidden, cfg.dtype)
        self.fc2 = Linear(hidden, cfg.width, cfg.dtype)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x), self.quick))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = Linear(cfg.width, 3 * cfg.width, cfg.dtype)
        self.proj = Linear(cfg.width, cfg.width, cfg.dtype)

    def forward(self, x):
        B, N, D = x.shape
        hd = D // self.heads
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        out = attention_core(qkv[0], qkv[1], qkv[2])         # (B, h, N, hd)
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v for (B, h, N, hd) operands in the
    compute dtype: q scaled in that dtype, the logits and the softmax in
    float32 (exact products of bf16 operands, TF32 off), the probabilities
    rounded back to the dtype for the product with v."""
    q = q * _const(q, q.shape[-1] ** -0.5)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        if cfg.layerscale:
            self.ls1 = LayerScale(cfg.width)
            self.ls2 = LayerScale(cfg.width)
        self.layerscale = cfg.layerscale

    def forward(self, x):
        h = self.attn(_layer_norm(self.norm1, x))
        if self.layerscale:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(_layer_norm(self.norm2, x))
        if self.layerscale:
            h = self.ls2(h)
        return x + h


class ViT(nn.Module):
    """images (B, 3, H, W), already normalized -> (cls (B, D or proj_dim)
    float32, patch tokens (B, H/p, W/p, D) float32)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.patch_embed = nn.Conv2d(3, c.width, c.patch, stride=c.patch,
                                     bias=c.patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.grid * c.grid + 1, c.width))
        if c.pre_ln:
            self.ln_pre = nn.LayerNorm(c.width, eps=c.ln_eps)
        for i in range(c.depth):
            self.add_module(f"block{i}", Block(c))
        self.norm = nn.LayerNorm(c.width, eps=c.ln_eps)
        if c.proj_dim is not None:
            self.proj = nn.Parameter(torch.zeros(c.width, c.proj_dim))

    def forward(self, images):
        c = self.cfg
        dt = c.dtype
        B, _, H, W = images.shape
        gh, gw = H // c.patch, W // c.patch
        pe = self.patch_embed
        x = F.conv2d(images.to(dt), pe.weight.to(dt), stride=c.patch)
        if pe.bias is not None:
            x = x + pe.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)                        # (B, T, D)
        x = torch.cat([self.cls_token.to(dt).expand(B, 1, c.width), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, gh, gw, c.grid).to(dt)
        if c.pre_ln:
            x = _layer_norm(self.ln_pre, x)
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
        x = _layer_norm(self.norm, x)
        cls_out = x[:, 0]
        patches = x[:, 1:].reshape(B, gh, gw, c.width)
        if c.proj_dim is not None:
            cls_out = cls_out @ self.proj
        return cls_out, patches


def interpolate_pos_embed(pos: torch.Tensor, gh: int, gw: int, grid: int) -> torch.Tensor:
    """Bilinear interpolation of the learned position embedding (1, 1 +
    grid², D) to a gh x gw token grid (DINOv2 interpolate_pos_encoding)."""
    from roman_tpu_torch.ops.image import resize_bilinear

    if gh == grid and gw == grid:
        return pos
    D = pos.shape[-1]
    patch_pos = pos[:, 1:].reshape(1, grid, grid, D).permute(0, 3, 1, 2)
    patch_pos = resize_bilinear(patch_pos, (gh, gw))
    return torch.cat([pos[:, :1], patch_pos.flatten(2).transpose(1, 2)], dim=1)


def upsample_patch_features(patches: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear per-pixel upsample of (B, gh, gw, D) patch features to
    (B, out_h, out_w, D) (reference fastsam_wrapper.py:602-648)."""
    from roman_tpu_torch.ops.image import resize_bilinear

    x = resize_bilinear(patches.permute(0, 3, 1, 2), (out_h, out_w))
    return x.permute(0, 2, 3, 1)


def init_vit_(model: ViT, generator: torch.Generator) -> ViT:
    """Seeded random weights with the flax init's distributions: kernels
    normal with variance 1/fan_in, biases 0, norms 1 and 0, pos embed and
    proj normal(0.02), cls 0, LayerScale 1e-5."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("pos_embed", "proj"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif leaf == "weight" and p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif leaf == "gamma":
                p.fill_(1e-5)
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
    return model
