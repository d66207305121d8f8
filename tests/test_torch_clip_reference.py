"""The front end's CLIP crop semantics against the benchmark's plain float32
reference, `benchmark/reference/clip_f32.py`, on the CPU at tiny widths:
the reference against transformers' CLIPVisionModelWithProjection (the
golden fixture), the port's PerceptionFrontend(semantics="clip") against
the reference on the same masks and weights, the stage's encoding of the
kept slots alone (in chunks of `wrapper.CLIP_CHUNK` crops), and its span,
wait and counters (`perception.clip`, `perception.clip_crops`,
`perception.clip_encoded`, `perception.clip_kept`) under a profiler."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import clip_f32
from roman_tpu_torch import tracing
from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.perception import clip, fastsam, wrapper

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "perception_golden.npz")
# the golden fixture's CLIP: transformers' tiny CLIPVisionModelWithProjection
GOLDEN_ARCH = clip_f32.ClipArch(width=32, depth=2, heads=4, img_size=56, mlp=128, proj_dim=16)
TINY = clip_f32.ARCHS["tiny"]
HW = (64, 96)


def test_the_reference_is_transformers_clip():
    """clip_f32.encode on the golden state dict (transformers' keys) gives
    transformers' image_embeds within float32 rounding, with no port code."""
    g = np.load(GOLDEN)
    sd = {k[len("clip.sd."):]: torch.tensor(g[k]) for k in g.files if k.startswith("clip.sd.")}
    assert set(sd) == set(clip_f32.clip_spec(GOLDEN_ARCH))
    with torch.no_grad():
        emb = clip_f32.encode(sd, GOLDEN_ARCH, torch.tensor(g["image"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(emb.numpy(), g["clip.expected_image_embeds"], atol=2e-5)


def _frontend(rotate_img=None):
    """The port's tiny front end in float32 with CLIP semantics, CLIP's
    weights the reference's draw through the port's loader; and those
    weights."""
    cfg = dataclasses.replace(clip.CLIP_VIT_L14, width=TINY.width, depth=TINY.depth,
                              heads=TINY.heads, img_size=TINY.img_size, proj_dim=TINY.proj_dim,
                              dtype=torch.float32)
    w = clip_f32.draw_weights(7, TINY, "cpu")
    params = FastSAMParams(imgsz=HW, seg_arch="tiny", vit_arch="tiny", max_masks_per_frame=8,
                           max_points_per_mask=64, conf=0.0, min_mask_len_div=30,
                           max_mask_len_div=1, semantics="clip", rotate_img=rotate_img)
    fe = wrapper.PerceptionFrontend(
        params, CameraParams.simple(width=HW[1], height=HW[0], f=60.0),
        seg_cfg=dataclasses.replace(fastsam.TINY_TEST, dtype=torch.float32), clip_cfg=cfg,
        clip_weights=clip.convert_torch_state_dict(w, cfg), device="cpu")
    return fe, w


def _frames():
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2,) + HW + (3,)).astype(np.float32)
    depths = rng.uniform(1.0, 8.5, size=(2,) + HW).astype(np.float32)
    return images, depths


@pytest.mark.parametrize("rotate_img", [None, "CW"])
def test_the_ports_clip_embeddings_are_the_references(rotate_img):
    """Every kept mask's embedding from the port's program (its boxes,
    crop_resize, the ViT) against the reference's box, stretched crop and
    tower on the masks and rotated images the stage was given; a dropped
    slot's embedding is 0. Tolerance 1e-5 on 1 - cosine: both sides are
    float32 (TF32 does not arise on the CPU), and they differ only in the
    order of the resample's sums (two batched products against one einsum)
    and in the q/k/v projections (one fused product against three); it
    read 1.2e-7."""
    fe, w = _frontend(rotate_img)
    seen = {}
    stage = fe.clip_stage

    def clip_stage(imgs_p, masks_r, ok, graph=True):
        seen.update(imgs=imgs_p, masks=masks_r)
        return stage(imgs_p, masks_r, ok, graph)

    fe.clip_stage = clip_stage
    with torch.no_grad():
        out = fe.program(*fe.inputs(*_frames()))
        fi, ki = torch.nonzero(out["valid"]).T
        assert len(fi) >= 8 and seen["masks"][fi, ki].flatten(1).any(-1).all()
        want = clip_f32.embeddings(w, TINY, seen["imgs"], seen["masks"],
                                   (fi.numpy(), ki.numpy()))
    got = out["embeddings"][fi, ki]
    assert (1.0 - (got * want).sum(-1)).abs().max() <= 1e-5
    assert (got - want).abs().max() <= 1e-5
    assert not out["embeddings"][~out["valid"]].any()
    # the program's boxes are upstream's, ends one past the reference's
    box = wrapper._mask_bboxes(seen["masks"])[fi, ki].long()
    assert torch.equal(box, clip_f32.boxes(seen["masks"][fi, ki]) + torch.tensor([0, 0, 1, 1]))


C = wrapper.CLIP_CHUNK
SLOTS = (2, C // 2 + 1)  # B x K = C + 2 slots, more than a chunk and one


@pytest.fixture(scope="module")
def every_slot():
    """The tiny front end, seeded frames and box masks of SLOTS, and every
    slot's embedding by clip_bbox_embeddings with the plain tower."""
    fe, _ = _frontend()
    B, K = SLOTS
    g = torch.Generator().manual_seed(5)
    imgs = torch.rand((B, 3) + HW, generator=g)
    y0 = torch.randint(0, HW[0] - 8, (B, K), generator=g)
    x0 = torch.randint(0, HW[1] - 8, (B, K), generator=g)
    ys, xs = torch.arange(HW[0]), torch.arange(HW[1])
    rows = (ys >= y0[..., None]) & (ys < y0[..., None] + 8 + (x0 % 17)[..., None])
    cols = (xs >= x0[..., None]) & (xs < x0[..., None] + 8 + (y0 % 23)[..., None])
    masks = rows[..., :, None] & cols[..., None, :]
    with torch.no_grad():
        want = wrapper.clip_bbox_embeddings(imgs, wrapper._mask_bboxes(masks), fe.clip_model,
                                            out_size=fe.clip_cfg.img_size)
    return fe, imgs, masks, want


@pytest.mark.parametrize("n_kept", [0, 1, C - 1, C, C + 1, SLOTS[0] * SLOTS[1]])
def test_the_stage_encodes_the_kept_slots_alone(every_slot, n_kept):
    """The stage with n_kept of the slots kept, at chunk edges and past
    them: the kept slots' embeddings are every slot's (the tower on other
    chunks of crops, float32), the dropped ones exactly 0; under a profiler
    it counts every slot as given, and the crops the tower ran, padding
    included, as encoded: whole chunks."""
    fe, imgs, masks, want = every_slot
    ok = torch.zeros(SLOTS, dtype=torch.bool)
    ok.view(-1)[torch.randperm(ok.numel(), generator=torch.Generator().manual_seed(n_kept))
                [:n_kept]] = True
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            got = fe.clip_stage(imgs, masks, ok, graph=False)
        assert tracing.counter("perception.clip_crops") == ok.numel()
        assert tracing.counter("perception.clip_encoded") == -(-n_kept // C) * C
        assert tracing.counter("perception.clip_kept") == n_kept
    finally:
        tracing.reset()
    assert got.shape == want.shape
    assert torch.where(ok[..., None], got - want, 0.0).abs().max() <= 1e-6
    assert not got[~ok].any()


def test_the_clip_stage_is_traced_and_counted(monkeypatch):
    """Under a profiler the stage records its span once a batch, counts
    every slot as given, the crops the tower ran (whole chunks) as encoded
    and the program's valid slots as kept, and counts one wait, for the
    kept slots' count, before its span opens; with no profiler it records
    and counts nothing."""
    fe, _ = _frontend()
    images, depths = _frames()
    waits = []
    count_sync = tracing.count_sync

    def wait(device, n=1):
        waits.append((time.perf_counter_ns(), n))
        count_sync(device, n)

    monkeypatch.setattr(tracing, "count_sync", wait)
    tracing.reset()
    with torch.no_grad():
        fe.program(*fe.inputs(images, depths))
    assert not tracing.records() and not tracing.counted("perception.clip_crops")
    assert not tracing.counted("perception.clip_encoded")
    waits.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        out = fe.program(*fe.inputs(images, depths))
    try:
        spans = tracing.records()
        assert [r.name for r in spans] == ["perception.clip"]
        assert len(waits) == 1 and waits[0][1] == 1 and waits[0][0] < spans[0].start_ns
        crops = tracing.counter("perception.clip_crops")
        assert crops == out["valid"].numel() == 2 * 8
        kept = int(out["valid"].sum())
        assert tracing.counter("perception.clip_kept") == kept <= crops
        assert tracing.counter("perception.clip_encoded") == -(-kept // C) * C
    finally:
        tracing.reset()
