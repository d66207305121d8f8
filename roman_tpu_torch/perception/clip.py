"""CLIP image encoder and its weight loader: a port of
roman_tpu/perception/clip.py.

Replaces the reference's OpenAI CLIP ViT-L/14 usage for per-mask bbox
embeddings (fastsam_wrapper.py:181-183, :393-406). Weights load from a
transformers ``CLIPVisionModelWithProjection`` state dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from roman_tpu_torch.perception.dinov2 import INV_255, _tensor, normalize
from roman_tpu_torch.perception.vit import ViT, ViTConfig

CLIP_VIT_L14 = ViTConfig(width=1024, depth=24, heads=16, patch=14, img_size=224,
                         layerscale=False, quick_gelu=True, pre_ln=True,
                         proj_dim=768, patch_bias=False, ln_eps=1e-5,
                         dtype=torch.bfloat16)
CLIP_VIT_B32 = ViTConfig(width=768, depth=12, heads=12, patch=32, img_size=224,
                         layerscale=False, quick_gelu=True, pre_ln=True,
                         proj_dim=512, patch_bias=False, ln_eps=1e-5,
                         dtype=torch.bfloat16)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def make_model(cfg: ViTConfig = CLIP_VIT_L14) -> ViT:
    return ViT(cfg)


def preprocess(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 RGB -> normalized float."""
    return normalize(images_uint8.float() * INV_255, CLIP_MEAN, CLIP_STD)


def convert_torch_state_dict(sd: Dict[str, object], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """transformers CLIPVisionModel(WithProjection) state dict -> the
    port's ViT state dict (``vision_model.`` prefix optional)."""
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""

    def t(key):
        return _tensor(sd[pre + key])

    out = {
        "patch_embed.weight": t("embeddings.patch_embedding.weight"),
        "cls_token": t("embeddings.class_embedding").reshape(1, 1, -1),
        "pos_embed": t("embeddings.position_embedding.weight")[None],
        "ln_pre.weight": t("pre_layrnorm.weight"),
        "ln_pre.bias": t("pre_layrnorm.bias"),
        "norm.weight": t("post_layernorm.weight"),
        "norm.bias": t("post_layernorm.bias"),
    }
    for i in range(cfg.depth):
        pre_i, b = f"encoder.layers.{i}", f"block{i}"
        att = f"{pre_i}.self_attn"
        out.update({
            f"{b}.norm1.weight": t(f"{pre_i}.layer_norm1.weight"),
            f"{b}.norm1.bias": t(f"{pre_i}.layer_norm1.bias"),
            f"{b}.attn.qkv.weight": torch.cat(
                [t(f"{att}.{n}_proj.weight") for n in "qkv"]),
            f"{b}.attn.qkv.bias": torch.cat(
                [t(f"{att}.{n}_proj.bias") for n in "qkv"]),
            f"{b}.attn.proj.weight": t(f"{att}.out_proj.weight"),
            f"{b}.attn.proj.bias": t(f"{att}.out_proj.bias"),
            f"{b}.norm2.weight": t(f"{pre_i}.layer_norm2.weight"),
            f"{b}.norm2.bias": t(f"{pre_i}.layer_norm2.bias"),
            f"{b}.mlp.fc1.weight": t(f"{pre_i}.mlp.fc1.weight"),
            f"{b}.mlp.fc1.bias": t(f"{pre_i}.mlp.fc1.bias"),
            f"{b}.mlp.fc2.weight": t(f"{pre_i}.mlp.fc2.weight"),
            f"{b}.mlp.fc2.bias": t(f"{pre_i}.mlp.fc2.bias"),
        })
    if "visual_projection.weight" in sd:
        out["proj"] = _tensor(sd["visual_projection.weight"]).t().contiguous()
    return out
