"""The port's perception front end on the card against the same code on the
CPU, and its bf16 nets against f32 ones on the card.

Needs a CUDA card; without one every test skips. These tests import
nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \\
        -m cuda tests/test_torch_perception_cuda.py

The front end has no hand-written kernel: its ops are torch code, and the
CPU run is their referee (perception.agreement). The limits, those of
chip_smoke.py phase 11:
- f32 nets, card against CPU: head outputs and prototypes within 1e-3 of
  each tensor's largest entry, ViT patch tokens within 1e-4; at least 90%
  of the proposals found in both runs (matched by anchor); their masks
  equal away from the knife edge (|mask logit| < 1e-4) and, at full
  width, at least half of them equal everywhere (the tiny net: one); for
  those, validity and valid points equal,
  points within 1e-3 m, embeddings and frame descriptors at cosine
  0.9999 or more;
- bf16 against f32 nets on the card: at least half of the proposals
  matched, mean mask IoU 0.8, mean embedding cosine and frame descriptor
  cosine 0.99.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.perception import clip
from roman_tpu_torch.perception.agreement import front_end_agreement
from roman_tpu_torch.perception.wrapper import (CLIP_CHUNK, SEG_ARCHS, VIT_ARCHS,
                                                 PerceptionFrontend)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(n, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, H, W, 3)).astype(np.float32),
            rng.uniform(1.0, 6.0, size=(n, H, W)).astype(np.float32))


def _f32(params):
    return dict(seg_cfg=dataclasses.replace(SEG_ARCHS[params.seg_arch], dtype=torch.float32),
                vit_cfg=dataclasses.replace(VIT_ARCHS[params.vit_arch], dtype=torch.float32))


SIZES = {"tiny": (dict(seg_arch="tiny", vit_arch="tiny", imgsz=(96, 128)), 2, 96, 128),
         "full": (dict(seg_arch="fastsam-x", vit_arch="dinov2-base", imgsz=(256, 256)), 1,
                  480, 640)}


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_front_end_on_the_card_matches_the_cpu(dev, size):
    kw, n, H, W = SIZES[size]
    params = FastSAMParams(max_masks_per_frame=64, max_points_per_mask=256, **kw)
    cam = CameraParams.simple(width=W, height=H)
    card = PerceptionFrontend(params, cam, device=dev, **_f32(params))
    cpu = PerceptionFrontend(params, cam, device="cpu", **_f32(params))
    r = front_end_agreement(card, cpu, *_frames(n, H, W))
    assert r["net_rel"] <= 1e-3 and r["vit_rel"] <= 1e-4, r
    assert r["matched"] >= 0.9 and r["diff_off_edge"] == 0, r
    # the tiny net's mask logits are ~1e-4: a third of its pixels lie on
    # the knife edge, so fewer of its masks are equal everywhere
    assert r["same"] >= (r["matched"] * 64 * n / 2 if size == "full" else 1), r
    assert r["valid_equal_same"] and r["points_valid_equal"] and r["point_err"] <= 1e-3, r
    assert r["emb_cos_min_same"] >= 0.9999 and r["fd_cos"] >= 0.9999, r


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_graph_replay_equals_the_eager_program(dev, size):
    """The nets' half of a batch replayed as a CUDA graph (run_batch's
    path on the card) gives the eager program's outputs bit for bit: the
    same kernels on the same inputs. Two frames; the capture, then a
    replay."""
    kw, _, H, W = SIZES[size]
    params = FastSAMParams(max_masks_per_frame=64, max_points_per_mask=256, **kw)
    fe = PerceptionFrontend(params, CameraParams.simple(width=W, height=H), device=dev)
    img, dep = fe.inputs(*_frames(2, H, W))
    eager = fe.program(img, dep, graph=False)
    for _ in range(2):
        got = fe.program(img, dep)
        for k, v in eager.items():
            assert torch.equal(got[k], v), k
    assert list(fe._graphs) == [tuple(img.shape)]


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_the_clip_stage_replays_as_the_eager_program(dev, size):
    """With CLIP semantics the tower replays one CUDA graph of CLIP_CHUNK
    crops, once a chunk of the kept slots, after the nets' graph and the
    filters: the same outputs as the eager program, which runs the same
    chunks, bit for bit. Then the stage alone with a kept count past a
    chunk's edge (one more than a chunk: a last chunk of one kept slot and
    its padding), graph against eager. Full size is CLIP ViT-L/14 on 2 x
    64 crops."""
    kw, _, H, W = SIZES[size]
    params = FastSAMParams(max_masks_per_frame=64, max_points_per_mask=256, semantics="clip",
                           **kw)
    clip_cfg = (None if size == "full" else dataclasses.replace(
        clip.CLIP_VIT_L14, width=64, depth=2, heads=4, img_size=56, proj_dim=64))
    fe = PerceptionFrontend(params, CameraParams.simple(width=W, height=H), clip_cfg=clip_cfg,
                            device=dev)
    img, dep = fe.inputs(*_frames(2, H, W))
    eager = fe.program(img, dep, graph=False)
    assert eager["embeddings"].shape == (2, 64, fe.embedding_dim)
    for _ in range(2):
        got = fe.program(img, dep)
        for k, v in eager.items():
            assert torch.equal(got[k], v), k
    n = CLIP_CHUNK // 64 + 1  # frames of 64 slots, more than a chunk and one
    img, _ = fe.inputs(*_frames(n, H, W))
    masks = torch.zeros((n, 64, H, W), dtype=torch.bool, device=dev)
    for i in range(n * 64):
        y, x = (7 * i) % (H - 24), (13 * i) % (W - 24)
        masks[i // 64, i % 64, y:y + 8 + i % 16, x:x + 8 + i % 13] = True
    ok = torch.zeros((n, 64), dtype=torch.bool, device=dev)
    ok.view(-1)[torch.randperm(n * 64, generator=torch.Generator().manual_seed(1))
                [:CLIP_CHUNK + 1].to(dev)] = True
    with torch.no_grad():
        want = fe.clip_stage(img, masks, ok, graph=False)
        got = fe.clip_stage(img, masks, ok)
    assert torch.equal(got, want) and not got[~ok].any()
    S = fe.clip_cfg.img_size
    assert list(fe._graphs) == [(2, 3, H, W), ("clip", CLIP_CHUNK, 3, S, S)]


def test_bf16_front_end_stays_near_f32_on_the_card(dev):
    kw, n, H, W = SIZES["full"]
    params = FastSAMParams(max_masks_per_frame=64, max_points_per_mask=256, **kw)
    cam = CameraParams.simple(width=W, height=H)
    b16 = PerceptionFrontend(params, cam, device=dev)
    f32 = PerceptionFrontend(params, cam, device=dev, **_f32(params))
    r = front_end_agreement(b16, f32, *_frames(n, H, W))
    assert r["matched"] >= 0.5 and r["iou"] >= 0.8, r
    assert r["emb_cos_mean"] >= 0.99 and r["fd_cos"] >= 0.99, r


def test_map_runner_maps_rgbd_frames_on_the_card(dev):
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.mapper_params import MapperParams

    T, H, W = 8, 96, 128
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(T, H, W, 3)).astype(np.uint8)
    depths = np.full((T, H, W), 3.0, np.float32)
    depths[:, 30:60, 40:70] = 1.5
    times = np.arange(T) * 0.25
    poses = np.stack([np.eye(4)] * T)
    poses[:, 0, 3] = 0.2 * times
    fs = FastSAMParams(imgsz=(96, 128), seg_arch="tiny", vit_arch="tiny", batch_frames=4,
                       max_masks_per_frame=8, max_points_per_mask=64, conf=0.0,
                       min_mask_len_div=40, max_mask_len_div=1)
    mp = MapperParams(min_sightings=1, max_t_no_sightings=2.0,
                      geometric_score_range=(0.05, 1.0), mapper_backend="device",
                      max_segments=64, max_points_per_segment=64)
    runner = MapRunner(mp, fs, CameraParams.simple(width=W, height=H, f=100.0),
                       PoseData.from_times_and_poses(times, poses), dt=0.25, device=dev)
    roman_map = runner.run(lambda ts: (images[np.rint(ts / 0.25).astype(int)],
                                       depths[np.rint(ts / 0.25).astype(int)]))
    assert runner.frontend.device.type == "cuda"
    assert len(roman_map.segments) > 0
    assert all(np.asarray(s.semantic_descriptor).shape == (64,) for s in roman_map.segments)
