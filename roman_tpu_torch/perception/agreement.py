"""How far two runs of the front end agree: the referee of the card
against the CPU, and of bf16 nets against f32 ones (chip_smoke.py phase
11, tests/test_torch_perception_cuda.py).

Two front ends with the same weights take the same frames. Their nets are
compared relative to each tensor's largest entry. Their proposals are
matched by the anchor each came from (the NMS order may differ where two
scores nearly tie), then compared: masks in the segmentation net's frame,
equal away from the knife edge (pixels whose mask logit is so close to 0
that the nets' rounding may tip them), and, for the proposals whose masks
are equal, validity, points and embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from roman_tpu_torch.ops.image import resize_bilinear
from roman_tpu_torch.perception import dinov2, fastsam


def _match(a: np.ndarray, b: np.ndarray):
    """Indices of the proposals of two runs that share an anchor."""
    pos = {int(x): i for i, x in enumerate(b)}
    pairs = [(i, pos[int(x)]) for i, x in enumerate(a) if int(x) in pos]
    return (np.array([p[0] for p in pairs], int), np.array([p[1] for p in pairs], int))


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)


def _run(fe, images: np.ndarray, depths: np.ndarray, knife_edge: float):
    from roman_tpu_torch.perception.wrapper import _r32

    img, dep = fe.inputs(images, depths)
    p, c = fe.params, fe.vit_cfg
    hw = (_r32(p.imgsz[0]), _r32(p.imgsz[1]))
    H, W = img.shape[-2:]
    with torch.no_grad():
        net = fe.seg_model(resize_bilinear(img, hw))
        _, patches = fe.vit_model(dinov2.normalize(
            resize_bilinear(img, (H // c.patch * c.patch, W // c.patch * c.patch)),
            dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD))
        _, boxes, _, coeffs, keep = fastsam.select_proposals(
            net, fe.seg_cfg, hw, p.conf, p.iou, p.max_masks_per_frame)
        logits = fastsam.mask_logits(net["proto"], coeffs, hw)
        masks = fastsam.assemble_masks(net["proto"], coeffs, boxes, hw) & keep[..., None, None]
    tensors = [t.float().cpu() for lvl in net["levels"] for t in lvl] + [net["proto"].cpu()]
    out = {k: v.cpu().numpy() for k, v in fe.program(img, dep).items()}
    return (tensors, patches.float().cpu(), masks.cpu().numpy(),
            (logits.abs() < knife_edge).cpu().numpy(), out)


def front_end_agreement(fe_a, fe_b, images: np.ndarray, depths: np.ndarray,
                        knife_edge: float = 1e-4) -> dict:
    """images (B, H, W, 3), depths (B, H, W) through both front ends ->
    the numbers of their agreement, over all frames (see the module)."""
    ta, pa, ma_s, edge, a = _run(fe_a, images, depths, knife_edge)
    tb, pb, mb_s, _, b = _run(fe_b, images, depths, knife_edge)
    res = {"net_rel": max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(ta, tb)),
           "vit_rel": float((pa - pb).abs().max() / pb.abs().max())}
    pairs = [_match(a["anchors"][f], b["anchors"][f]) for f in range(len(images))]
    fa = np.concatenate([np.full(len(i), f) for f, (i, _) in enumerate(pairs)]).astype(int)
    ia = np.concatenate([i for i, _ in pairs]).astype(int)
    ib = np.concatenate([j for _, j in pairs]).astype(int)

    def take(run, key, idx):
        return run[key][fa, idx]

    res["matched"] = len(ia) / a["anchors"].size
    res["valid_equal"] = float((take(a, "valid", ia) == take(b, "valid", ib)).mean())
    ma, mb = take(a, "masks", ia), take(b, "masks", ib)
    res["iou"] = float(((ma & mb).sum((-2, -1))
                        / np.maximum((ma | mb).sum((-2, -1)), 1)).mean())
    diff = ma_s[fa, ia] != mb_s[fa, ib]
    on_edge = edge[fa, ia]
    res["diff_pixels"], res["diff_off_edge"] = int(diff.sum()), int((diff & ~on_edge).sum())
    res["edge_pixels"], res["pixels"] = int(on_edge.sum()), int(on_edge.size)
    same = ~diff.reshape(len(ia), -1).any(-1)
    res["same"] = int(same.sum())
    res["valid_equal_same"] = bool(np.array_equal(take(a, "valid", ia)[same],
                                                  take(b, "valid", ib)[same]))
    pv = take(a, "points_valid", ia)[same]
    res["points_valid_equal"] = bool(np.array_equal(pv, take(b, "points_valid", ib)[same]))
    d = np.abs(take(a, "points", ia)[same] - take(b, "points", ib)[same]) * pv[..., None]
    res["point_err"] = float(d.max()) if d.size else 0.0
    cos = _cos(take(a, "embeddings", ia), take(b, "embeddings", ib))
    res["emb_cos_min_same"] = float(cos[same].min()) if same.any() else 1.0
    res["emb_cos_mean"] = float(cos.mean()) if cos.size else 1.0
    res["fd_cos"] = float(_cos(a["frame_descriptors"], b["frame_descriptors"]).min())
    return res
