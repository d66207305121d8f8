"""The work of the front end a frame, counted from the published layer
shapes (frontend_f32's upstream layouts), independently of how the
program computes it. A product of an m x k by a k x n matrix is 2 m k n
operations; a convolution is 2 cin cout kh kw operations an output pixel
(a transposed one, an input pixel).

- bfloat16 (the configuration's products): every convolution of FastSAM-x
  at the net's input size, and of DINOv2 the patch embedding, the
  q/k/v, output, and MLP projections and the probabilities times v;
- float32: DINOv2's attention logits (q k^T, float32 products of bf16
  operands in the configuration), the mask logits (coefficients times
  prototypes) and the mask-weighted patch pooling.

Bytes: the frame's RGB (uint8) and depth (float32) read once.
"""

from __future__ import annotations

import math

from benchmark.reference import frontend_f32 as ref

# the stride of each yolov8-seg module's output, as a divisor of the input
_SEG_STRIDE = {"0": 2, "1": 4, "2": 4, "3": 8, "4": 8, "5": 16, "6": 16, "7": 32, "8": 32,
               "9": 32, "12": 16, "15": 8, "16": 16, "18": 16, "19": 32, "21": 32}


def seg_ops(a: ref.SegArch, h: int, w: int) -> float:
    """FastSAM-x's convolution operations at an h x w input."""
    total = 0.0
    for key, shape in ref.seg_spec(a).items():
        if not key.endswith("weight") or len(shape) != 4:
            continue
        parts = key.split(".")
        if parts[1] != "22":
            stride = _SEG_STRIDE[parts[1]]
        elif parts[2] == "proto":
            stride = 8 if parts[3] in ("cv1", "upsample") else 4
        else:
            stride = ref.STRIDES[int(parts[3])]
        total += 2.0 * math.prod(shape) * (h // stride) * (w // stride)
    return total


def vit_ops(a: ref.VitArch, gh: int, gw: int) -> tuple:
    """(bf16, f32) operations of DINOv2 on a gh x gw patch grid."""
    T, D = gh * gw + 1, a.width
    hidden = int(D * a.mlp_ratio)
    per_layer = 2.0 * T * D * (3 * D + D + 2 * hidden) + 2.0 * T * T * D
    bf16 = a.depth * per_layer + 2.0 * gh * gw * 3 * a.patch ** 2 * D
    f32 = a.depth * 2.0 * T * T * D
    return bf16, f32


def frame_work(seg: ref.SegArch, vit: ref.VitArch, fparams, H: int, W: int) -> dict:
    """{"bytes", "f32_ops", "bf16_ops"} of one H x W frame."""
    s = [max(32, (int(x) // 32) * 32) for x in fparams.imgsz]
    gh, gw = H // vit.patch, W // vit.patch
    v16, v32 = vit_ops(vit, gh, gw)
    K = fparams.max_masks_per_frame
    post = 2.0 * K * seg.nm * (s[0] // 4) * (s[1] // 4) + 2.0 * K * gh * gw * vit.width
    return {"bytes": float(H * W * 3 + H * W * 4), "f32_ops": v32 + post,
            "bf16_ops": seg_ops(seg, *s) + v16}
