"""DINOv2 image encoder and its weight loader: a port of
roman_tpu/perception/dinov2.py.

Replaces the reference's DINOv2-base usage (fastsam_wrapper.py:184-188):
per-pixel patch features for mask embeddings and gap/gmp/gem-pooled frame
descriptors (fastsam_wrapper.py:650-666). Weights load from a
transformers ``Dinov2Model`` state dict (facebook/dinov2-base layout).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from roman_tpu_torch.perception.vit import ViT, ViTConfig

DINOV2_BASE = ViTConfig(width=768, depth=12, heads=12, patch=14, img_size=518,
                        layerscale=True, dtype=torch.bfloat16)
DINOV2_SMALL = ViTConfig(width=384, depth=12, heads=6, patch=14, img_size=518,
                         layerscale=True, dtype=torch.bfloat16)

# ImageNet normalization used by DINOv2 preprocessing
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# uint8 -> [0, 1] as XLA evaluates roman_tpu's x / 255: times f32(1 / 255)
INV_255 = float(np.float32(1.0) / np.float32(255.0))


def make_model(cfg: ViTConfig = DINOV2_BASE) -> ViT:
    return ViT(cfg)


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(..., 3, H, W) float in [0, 1] -> per-channel standardized: (x -
    mean) * f32(1 / std), as XLA evaluates roman_tpu's (x - mean) / std for
    its constant std. The constants are Python scalars, so no host copy
    enters the program (it may be captured in a CUDA graph)."""
    inv = np.float32(1.0) / np.asarray(std, np.float32)
    return torch.cat([(images[..., c:c + 1, :, :] - float(mean[c])) * float(inv[c])
                      for c in range(3)], dim=-3)


def preprocess(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 RGB -> normalized float."""
    return normalize(images_uint8.float() * INV_255, IMAGENET_MEAN, IMAGENET_STD)


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v))


def convert_torch_state_dict(sd: Dict[str, object], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """transformers Dinov2Model state dict -> the port's ViT state dict.

    Key layout (transformers>=4.31 Dinov2Model):
      embeddings.cls_token, embeddings.mask_token, embeddings.position_embeddings,
      embeddings.patch_embeddings.projection.{weight,bias},
      encoder.layer.{i}.norm1.{weight,bias}
      encoder.layer.{i}.attention.attention.{query,key,value}.{weight,bias}
      encoder.layer.{i}.attention.output.dense.{weight,bias}
      encoder.layer.{i}.layer_scale1.lambda1
      encoder.layer.{i}.norm2..., .mlp.fc1/.fc2..., .layer_scale2.lambda1
      layernorm.{weight,bias}
    """
    def t(key):
        return _tensor(sd[key])

    out = {
        "patch_embed.weight": t("embeddings.patch_embeddings.projection.weight"),
        "patch_embed.bias": t("embeddings.patch_embeddings.projection.bias"),
        "cls_token": t("embeddings.cls_token"),
        "pos_embed": t("embeddings.position_embeddings"),
        "norm.weight": t("layernorm.weight"),
        "norm.bias": t("layernorm.bias"),
    }
    for i in range(cfg.depth):
        pre, b = f"encoder.layer.{i}", f"block{i}"
        att = f"{pre}.attention.attention"
        out.update({
            f"{b}.norm1.weight": t(f"{pre}.norm1.weight"),
            f"{b}.norm1.bias": t(f"{pre}.norm1.bias"),
            f"{b}.attn.qkv.weight": torch.cat(
                [t(f"{att}.{n}.weight") for n in ("query", "key", "value")]),
            f"{b}.attn.qkv.bias": torch.cat(
                [t(f"{att}.{n}.bias") for n in ("query", "key", "value")]),
            f"{b}.attn.proj.weight": t(f"{pre}.attention.output.dense.weight"),
            f"{b}.attn.proj.bias": t(f"{pre}.attention.output.dense.bias"),
            f"{b}.ls1.gamma": t(f"{pre}.layer_scale1.lambda1"),
            f"{b}.norm2.weight": t(f"{pre}.norm2.weight"),
            f"{b}.norm2.bias": t(f"{pre}.norm2.bias"),
            f"{b}.mlp.fc1.weight": t(f"{pre}.mlp.fc1.weight"),
            f"{b}.mlp.fc1.bias": t(f"{pre}.mlp.fc1.bias"),
            f"{b}.mlp.fc2.weight": t(f"{pre}.mlp.fc2.weight"),
            f"{b}.mlp.fc2.bias": t(f"{pre}.mlp.fc2.bias"),
            f"{b}.ls2.gamma": t(f"{pre}.layer_scale2.lambda1"),
        })
    return out


def load_from_torch_file(path: str, cfg: ViTConfig = DINOV2_BASE) -> Dict[str, torch.Tensor]:
    """A saved Dinov2Model state dict (tensors only) -> the port's."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torch_state_dict(sd, cfg)
