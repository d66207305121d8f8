"""The work of the front end's CLIP stage, counted from CLIP ViT-L/14's
published layer shapes (clip_f32's upstream layout), independently of how
the program computes it. A product of an m x k by a k x n matrix is 2 m k n
operations.

A crop of T = 257 tokens (256 patches and the class token), width D,
MLP width M:

- bfloat16 (the configuration's products): the patch embedding
  (2 * 256 * 3 * 14^2 * D), each layer's q/k/v, output and MLP
  projections (2 T D (4 D + 2 M)) and the probabilities times v
  (2 T^2 D), and the class token's projection (2 D * 768);
- float32: each layer's attention logits q k^T (2 T^2 D: float32 products
  of bf16 operands in the configuration).

The crop's resample is not counted: a separable triangle filter needs
about 5 MFLOP a crop, under 0.01% of the tower's 162 GFLOP.

Bytes: the tower's weights read once a launch in bfloat16, and each
crop's embedding written once in float32.

The stage is charged by the crops of the masks the program kept (its
`valid`), not by the slots it encoded, so that a program that encodes
fewer slots reads the same work.
"""

from __future__ import annotations

import math

from benchmark.reference import clip_f32


def crop_ops(a: clip_f32.ClipArch) -> tuple:
    """(bf16, f32) operations of one crop."""
    T, D = a.tokens, a.width
    patches = T - 1
    layer16 = 2.0 * T * D * (4 * D + 2 * a.mlp) + 2.0 * T * T * D
    bf16 = (a.depth * layer16 + 2.0 * patches * 3 * a.patch ** 2 * D
            + 2.0 * D * a.proj_dim)
    f32 = a.depth * 2.0 * T * T * D
    return bf16, f32


def weight_bytes(a: clip_f32.ClipArch) -> float:
    """The tower's weights in bfloat16."""
    return 2.0 * sum(math.prod(s) for s in clip_f32.clip_spec(a).values())


def crops_work(a: clip_f32.ClipArch, crops: int, launches: int) -> dict:
    """{"bytes", "f32_ops", "bf16_ops"} of `crops` crops in `launches`
    launches of the stage."""
    bf16, f32 = crop_ops(a)
    return {"bytes": launches * weight_bytes(a) + crops * 4.0 * a.proj_dim,
            "f32_ops": crops * f32, "bf16_ops": crops * bf16}
