"""The perception front end of the PyTorch port against roman_tpu's, on the
CPU, at tiny sizes.

- the port's DINOv2, CLIP and YoloSeg loaded from the upstream state dicts
  in tests/fixtures/perception_golden.npz reproduce the frozen torch
  outputs (no JAX);
- the carrier (roman_tpu_torch.convert): flax variables of roman_tpu's nets
  give the same outputs in the port (ConvTranspose, BatchNorm statistics,
  the position embedding on a non-square grid, bf16 products);
- ops/image against jax.image.resize and scale_and_translate; NMS with tied
  scores, the label, edge, erosion and triangle filters, rotation, mask
  boxes and frame descriptors against roman_tpu's functions;
- one roman_tpu PerceptionFrontend.run_batch against the port's (the only
  front-end program JAX compiles here), MapRunner.run with the port's own
  front end, the one-frame FastSAMWrapper and the checkpoint files.
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from roman_tpu.data.camera import CameraParams as JCamera
from roman_tpu.params.fastsam_params import FastSAMParams as JParams
from roman_tpu.perception import clip as jclip
from roman_tpu.perception import dinov2 as jdinov2
from roman_tpu.perception import fastsam as jfastsam
from roman_tpu.perception import frame_descriptor as jfd
from roman_tpu.perception import vit as jvit
from roman_tpu.perception import wrapper as jwrapper
from roman_tpu_torch import convert
from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.ops import image
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.perception import checkpoints, clip, dinov2, fastsam, vit, wrapper
from roman_tpu_torch.perception import frame_descriptor as tfd

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "perception_golden.npz")
TINY_VIT = dict(width=32, depth=2, heads=4, patch=14, img_size=56)
TINY_CLIP = dict(TINY_VIT, layerscale=False, quick_gelu=True, pre_ln=True, proj_dim=16,
                 patch_bias=False, ln_eps=1e-5)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _sd(golden, prefix):
    return {k[len(prefix) + 4:]: v for k, v in golden.items() if k.startswith(prefix + ".sd.")}


def _nchw(x):
    return torch.tensor(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _tiny_yolo_f32():
    return (dataclasses.replace(fastsam.TINY_TEST, dtype=torch.float32),
            dataclasses.replace(jfastsam.TINY_TEST, dtype=jnp.float32))


def _yolo_outputs(model, image_nhwc):
    with torch.no_grad():
        out = model(_nchw(image_nhwc))
    return out


def _assert_yolo_golden(out, golden, tol=3e-5):
    for lvl in range(3):
        for name, got in zip(("box", "cls", "mc"), out["levels"][lvl]):
            np.testing.assert_allclose(_nhwc(got.float()), golden[f"yolo.expected_{name}{lvl}"],
                                       atol=tol, err_msg=f"{name} level {lvl}")
    np.testing.assert_allclose(_nhwc(out["proto"]), golden["yolo.expected_proto"], atol=tol)


# ---------------------------------------------------------------------------
# the nets from upstream state dicts (no JAX)
# ---------------------------------------------------------------------------

def test_dinov2_loads_transformers_weights(golden):
    """Dinov2Model state dict -> the port's ViT: last hidden state within
    2e-5 of transformers' (f32)."""
    cfg = vit.ViTConfig(**TINY_VIT, layerscale=True)
    model = vit.ViT(cfg)
    model.load_state_dict(dinov2.convert_torch_state_dict(_sd(golden, "dinov2"), cfg))
    with torch.no_grad():
        cls_out, patches = model(_nchw(golden["image"]))
    expected = golden["dinov2.expected_last_hidden"]
    np.testing.assert_allclose(cls_out.numpy(), expected[:, 0], atol=2e-5)
    np.testing.assert_allclose(patches.reshape(2, -1, 32).numpy(), expected[:, 1:], atol=2e-5)


def test_clip_loads_transformers_weights(golden):
    """CLIPVisionModelWithProjection state dict -> the port's ViT: image
    embeddings within 2e-5 of transformers' (f32)."""
    cfg = vit.ViTConfig(**TINY_CLIP)
    model = vit.ViT(cfg)
    model.load_state_dict(clip.convert_torch_state_dict(_sd(golden, "clip"), cfg))
    with torch.no_grad():
        cls_out, _ = model(_nchw(golden["image"]))
    np.testing.assert_allclose(cls_out.numpy(), golden["clip.expected_image_embeds"], atol=2e-5)


def test_yoloseg_loads_ultralytics_weights(golden):
    """ultralytics 'model.{idx}.*' state dict (Proto's ConvTranspose and
    BatchNorm running statistics included) -> the port's YoloSeg: every
    head output and the prototypes within 3e-5 of the torch mirror (f32)."""
    cfg, _ = _tiny_yolo_f32()
    model = fastsam.YoloSeg(cfg)
    model.load_state_dict(fastsam.convert_ultralytics_state_dict(_sd(golden, "yolo")))
    _assert_yolo_golden(_yolo_outputs(model, golden["yolo.image"]), golden)


def test_dfl_decode_and_mask_assembly_match_golden(golden):
    dfl = fastsam.dfl_decode(torch.tensor(golden["yolo.dfl_logits"]), 16)
    np.testing.assert_allclose(dfl.numpy(), golden["yolo.expected_dfl"], atol=1e-5)
    proto = torch.tensor(golden["yolo.mask_proto"]).permute(2, 0, 1)[None]
    logits = fastsam.mask_logits(proto, torch.tensor(golden["yolo.mask_coefs"])[None], (16, 16))
    np.testing.assert_allclose(torch.sigmoid(logits)[0].numpy(), golden["yolo.expected_masks"],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the carrier: roman_tpu's flax variables -> the port's state dicts
# ---------------------------------------------------------------------------

def test_carrier_yoloseg_from_roman_tpu_variables(golden):
    """roman_tpu's converter makes flax YoloSeg variables (params and
    batch_stats) from the golden state dict; the carrier takes them into
    the port, which reproduces the golden outputs within 3e-5."""
    cfg, jcfg = _tiny_yolo_f32()
    variables = jfastsam.convert_ultralytics_state_dict(_sd(golden, "yolo"), jcfg)
    model = fastsam.YoloSeg(cfg)
    model.load_state_dict(convert.yoloseg_state_dict_from_flax(variables))
    _assert_yolo_golden(_yolo_outputs(model, golden["yolo.image"]), golden)


@pytest.mark.parametrize("family", ["dinov2", "clip"])
def test_carrier_vit_from_roman_tpu_variables(golden, family):
    kw = TINY_VIT if family == "dinov2" else TINY_CLIP
    jmod = jdinov2 if family == "dinov2" else jclip
    tmod = dinov2 if family == "dinov2" else clip
    cfg, jcfg = vit.ViTConfig(**kw), jvit.ViTConfig(**kw)
    variables = jmod.convert_torch_state_dict(_sd(golden, family), jcfg)
    model = vit.ViT(cfg)
    sd = convert.vit_state_dict_from_flax(variables)
    assert set(sd) == set(tmod.convert_torch_state_dict(_sd(golden, family), cfg))
    model.load_state_dict(sd)
    with torch.no_grad():
        cls_out, patches = model(_nchw(golden["image"]))
    if family == "dinov2":
        np.testing.assert_allclose(patches.reshape(2, -1, 32).numpy(),
                                   golden["dinov2.expected_last_hidden"][:, 1:], atol=2e-5)
    else:
        np.testing.assert_allclose(cls_out.numpy(), golden["clip.expected_image_embeds"],
                                   atol=2e-5)


def _seeded_flax_variables(model, shape, rng):
    """Flax variables of `model` at input `shape` with seeded numpy values
    (eval_shape: nothing is compiled): kernels normal / sqrt(fan_in),
    biases, norms and BatchNorm statistics away from their identity
    values, so a dropped or transposed tensor shows."""
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("['gamma']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_carrier_vit_on_a_non_square_grid(dtype):
    """A flax ViT (trained grid 4 x 4) on a 56 x 70 input (4 x 5 tokens,
    position embedding interpolated on one axis) against the port with the
    same weights. f32: within 2e-5. bf16 products (flax Dense dtype): XLA
    rounds fused elementwise chains once and the port where its ops end,
    so the two bf16 programs differ by bf16 noise: on these unit-scale
    outputs (f32 layer norms) at most 5e-2 and 2 bf16 ulps (7.8e-3) on
    average, and no further from roman_tpu's bf16 output than 1.5 times
    the distance of that output from roman_tpu's f32 one."""
    kw = dict(TINY_VIT, layerscale=True)
    rng = np.random.default_rng(7)
    jmodel32 = jvit.ViT(jvit.ViTConfig(**kw, dtype=jnp.float32))
    variables = _seeded_flax_variables(jmodel32, (1, 56, 70, 3), rng)
    x = rng.normal(size=(2, 56, 70, 3)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    jcls, jpatches = jax.jit(jvit.ViT(jvit.ViTConfig(**kw, dtype=jdt)).apply)(
        variables, jnp.asarray(x))
    model = vit.ViT(vit.ViTConfig(**kw, dtype=tdt))
    model.load_state_dict(convert.vit_state_dict_from_flax(variables))
    with torch.no_grad():
        cls_out, patches = model(_nchw(x))
    assert patches.shape == (2, 4, 5, 32) and patches.dtype == torch.float32
    if dtype == "f32":
        for got, want in ((cls_out, jcls), (patches, jpatches)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        return
    _, j32 = jax.jit(jmodel32.apply)(variables, jnp.asarray(x))
    err = np.abs(patches.numpy() - np.asarray(jpatches, np.float32))
    noise = np.abs(np.asarray(jpatches, np.float32) - np.asarray(j32)).mean()
    assert err.max() <= 5e-2 and err.mean() <= 2 * 2.0 ** -8, (err.max(), err.mean())
    assert err.mean() <= 1.5 * noise, (err.mean(), noise)


# ---------------------------------------------------------------------------
# ops/image against jax.image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((48, 64), (20, 27)),
                                     ((48, 64), (96, 128)), ((37, 37), (34, 45)),
                                     ((16, 20), (33, 47))])
def test_resize_matches_jax(src, dst):
    """bilinear (antialiased when shrinking; 37x37 -> 34x45 is the
    position-embedding case, one axis shrinks and one grows) within 1e-6;
    nearest exactly, ties between two pixels included (16 -> 33, 20 ->
    47 have them)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst, "bilinear"))
    got = image.resize_bilinear(torch.tensor(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst, "nearest"))
    np.testing.assert_array_equal(image.resize_nearest(torch.tensor(x), dst).numpy(), want)


def test_divisions_by_constants_fold_as_in_roman_tpu_jit():
    """Inside a jit XLA turns x / c for a constant c into x * f32(1 / c);
    roman_tpu's mapper and front end run so. The port computes the same:
    voxel keys of points on voxel boundaries (a depth of 1.5 m at 0.05 m),
    the pinhole division of lifting, the uint8 and ImageNet scaling."""
    from roman_tpu.data import camera as jcam
    from roman_tpu.ops import voxel as jvoxel
    from roman_tpu_torch.data import camera as tcam
    from roman_tpu_torch.ops import voxel as tvoxel

    rng = np.random.default_rng(9)
    pts = np.round(rng.uniform(-3, 3, size=(4, 64, 3)) * 20) / 20          # on boundaries
    pts = pts.astype(np.float32)
    mask = np.ones((4, 64), bool)
    for vs in (0.05, 0.2):
        want = np.asarray(jax.jit(lambda p, m: jvoxel.voxel_keys(p, m, vs))(pts, mask))
        got = tvoxel.voxel_keys(torch.tensor(pts), torch.tensor(mask), vs).numpy()
        np.testing.assert_array_equal(got, want)
    # eager JAX divides: on these points its keys differ
    eager = np.asarray(jvoxel.voxel_keys(jnp.asarray(pts), jnp.asarray(mask), 0.2))
    assert (eager != got).any()
    K = np.asarray(CameraParams.simple(width=96, height=64, f=60.0).K, np.float32)
    depth = (np.round(rng.uniform(1, 6, size=(2, 64, 96)) * 4) / 4).astype(np.float32)
    want = np.asarray(jax.jit(lambda d: jcam.depth_image_to_points(d, jnp.asarray(K)))(depth))
    np.testing.assert_array_equal(
        tcam.depth_image_to_points(torch.tensor(depth), torch.tensor(K)).numpy(), want)
    u8 = rng.integers(0, 256, size=(2, 5, 7, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(lambda x: x.astype(jnp.float32) / 255.0)(u8))
    np.testing.assert_array_equal(u8.astype(np.float32) * dinov2.INV_255, want)
    x = rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: (a - jnp.asarray(jdinov2.IMAGENET_MEAN))
                              / jnp.asarray(jdinov2.IMAGENET_STD))(x))
    got = dinov2.normalize(_nchw(x), dinov2.IMAGENET_MEAN, dinov2.IMAGENET_STD)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_patch_feature_upsample_matches_roman_tpu():
    rng = np.random.default_rng(10)
    patches = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    want = np.asarray(jvit.upsample_patch_features(jnp.asarray(patches), 56, 70))
    got = vit.upsample_patch_features(torch.tensor(patches), 56, 70).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_crop_resize_matches_scale_and_translate():
    """Per-box crops resampled to 16 x 16 as roman_tpu's CLIP path does
    (scale_and_translate, "linear", antialiased), within 5e-6 on values in
    [0, 1] (the two products sum in another order)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(2, 40, 56, 3)).astype(np.float32)
    lo = rng.uniform(0, 20, size=(2, 5, 2))
    hi = lo + rng.uniform(0.5, 36, size=(2, 5, 2))
    boxes = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    boxes[0, 0] = [0, 0, 1, 1]                                # a 1 px box (empty mask)
    S = 16

    def crop_one(im, box):
        x1, y1, x2, y2 = box
        w, h = jnp.maximum(x2 - x1, 1.0), jnp.maximum(y2 - y1, 1.0)
        return jax.image.scale_and_translate(
            im, (S, S, 3), (0, 1, 2), jnp.stack([S / h, S / w, 1.0]),
            jnp.stack([-y1 * S / h, -x1 * S / w, 0.0]), method="linear")

    want = jax.jit(jax.vmap(lambda im, bx: jax.vmap(lambda b: crop_one(im, b))(bx)))(
        jnp.asarray(img), jnp.asarray(boxes))
    got = image.crop_resize(_nchw(img), torch.tensor(boxes), S).permute(0, 1, 3, 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


# ---------------------------------------------------------------------------
# post-processing and filters against roman_tpu
# ---------------------------------------------------------------------------

def test_nms_with_tied_scores_matches_roman_tpu():
    """Scores tie often with bf16 class logits (a random net gives exactly
    0.5); the port's stable sort keeps lax.top_k's lower-index-first order,
    so the kept indices are roman_tpu's."""
    rng = np.random.default_rng(3)
    B, A = 2, 300
    xy = rng.uniform(0, 100, size=(B, A, 2))
    wh = rng.uniform(2, 30, size=(B, A, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.choice([0.5, 0.5, 0.5, 0.625, 0.75, 0.25], size=(B, A)).astype(np.float32)
    for conf, iou, k in ((0.5, 0.5, 16), (0.6, 0.9, 64)):
        j_idx, j_keep = jax.jit(jfastsam.nms_topk, static_argnums=(2, 3, 4))(
            jnp.asarray(boxes), jnp.asarray(scores), conf, iou, k)
        t_idx, t_keep = fastsam.nms_topk(torch.tensor(boxes), torch.tensor(scores), conf, iou, k)
        np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
        np.testing.assert_array_equal(np.where(t_keep, t_idx, -1), np.where(j_keep, j_idx, -1))


def test_decode_predictions_matches_roman_tpu(golden):
    """DFL decode, anchors and the class argmax of detect_labeled on the
    golden head outputs."""
    cfg, jcfg = _tiny_yolo_f32()
    jout = {"levels": [tuple(jnp.asarray(golden[f"yolo.expected_{n}{lvl}"])
                             for n in ("box", "cls", "mc")) for lvl in range(3)]}
    tout = {"levels": [tuple(_nchw(golden[f"yolo.expected_{n}{lvl}"])
                             for n in ("box", "cls", "mc")) for lvl in range(3)]}
    want = jax.jit(lambda o: jfastsam.decode_predictions(o, jcfg, (64, 64), with_cls=True))(jout)
    got = fastsam.decode_predictions(tout, cfg, (64, 64), with_cls=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=1e-5)


def _random_masks(rng, B=2, K=5, H=24, W=32):
    masks = np.zeros((B, K, H, W), bool)
    for b in range(B):
        for k in range(K - 1):
            y0, x0 = rng.integers(0, H - 4), rng.integers(0, W - 4)
            masks[b, k, y0:y0 + rng.integers(2, 12), x0:x0 + rng.integers(2, 14)] = True
            masks[b, k] &= rng.uniform(size=(H, W)) > 0.15          # ragged
    return masks                                                    # last mask empty


def test_label_filters_and_mask_boxes_match_roman_tpu():
    rng = np.random.default_rng(4)
    masks = _random_masks(rng)
    valid = rng.uniform(size=masks.shape[:2]) > 0.2
    lo = rng.uniform(-4, 20, size=(2, 3, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 16, size=(2, 3, 2))], -1).astype(np.float32)
    boxes[:, -1] = 0.0                                              # padding rows
    for kw in (dict(ignore_boxes=boxes, ignore_frac=1e-9),
               dict(ignore_boxes=boxes, ignore_frac=0.5),
               dict(keep_boxes=boxes, keep_frac=0.3),
               dict(ignore_boxes=boxes[:, ::-1], keep_boxes=boxes, ignore_frac=0.2)):
        want = jwrapper.apply_label_filters(jnp.asarray(masks), jnp.asarray(valid),
                                            **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                               else v for k, v in kw.items()})
        got = wrapper.apply_label_filters(torch.tensor(masks), torch.tensor(valid),
                                          **{k: torch.tensor(np.ascontiguousarray(v))
                                             if isinstance(v, np.ndarray) else v
                                             for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(wrapper._mask_bboxes(torch.tensor(masks)).numpy(),
                                  np.asarray(jwrapper._mask_bboxes(jnp.asarray(masks))))


def test_erosion_and_rotation_match_roman_tpu():
    """Erosion with the ellipse footprint (sizes 3, 5, 7; border as
    foreground) equals roman_tpu's; with a stride it equals the strided
    full erosion; rotations equal jnp.rot90's."""
    rng = np.random.default_rng(5)
    masks = _random_masks(rng, H=30, W=40) | (rng.uniform(size=(2, 5, 30, 40)) > 0.9)
    for size in (3, 5, 7):
        want = np.asarray(jwrapper.erode_masks(jnp.asarray(masks), size))
        got = wrapper.erode_masks(torch.tensor(masks), size).numpy()
        np.testing.assert_array_equal(got, want)
        for s in (2, 4):
            np.testing.assert_array_equal(
                wrapper.erode_masks(torch.tensor(masks), size, stride=s).numpy(),
                want[..., ::s, ::s])
    for k in (3, 5, 7):
        fp = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)).astype(bool)
        np.testing.assert_array_equal(wrapper._ellipse_footprint(k), fp)
    imgs = rng.uniform(size=(2, 6, 8, 3)).astype(np.float32)
    for how in (None, "CW", "CCW", "180"):
        want = np.asarray(jwrapper.rotate_images(jnp.asarray(imgs), how))
        np.testing.assert_array_equal(_nhwc(wrapper.rotate_images(_nchw(imgs), how)), want)


def test_triangle_fill_matches_cv2():
    """The numpy fill equals roman_tpu's cv2.fillPoly mask, pixel for pixel:
    the triangles of tests/test_frontend_features.py, and seeded random
    integer triangles inside the image, crossing its border and far
    outside it."""
    H, W = 96, 128
    cases = [[[[30, 20], [100, 20], [64, 90]]], []]
    rng = np.random.default_rng(6)
    for lo, hi in (((0, 0), (W, H)), ((-30, -30), (W + 30, H + 30)),
                   ((-300, -300), (W + 300, H + 300))):
        cases += [[rng.integers(lo, hi, size=(3, 2)).tolist() for _ in range(2)]
                  for _ in range(150)]
    for tris in cases:
        np.testing.assert_array_equal(wrapper.triangle_ignore_mask(tris, H, W),
                                      jwrapper.triangle_ignore_mask(tris, H, W), err_msg=str(tris))


@pytest.mark.parametrize("kind", ["dino-gap", "dino-gmp", "dino-gem"])
def test_frame_descriptor_matches_roman_tpu(kind):
    rng = np.random.default_rng(8)
    patches = rng.normal(size=(3, 4, 5, 16)).astype(np.float32)
    want = np.asarray(jfd.frame_descriptor(jnp.asarray(patches), kind))
    np.testing.assert_allclose(tfd.frame_descriptor(torch.tensor(patches), kind).numpy(),
                               want, atol=1e-6)
    feats = rng.normal(size=(6, 7, 16)).astype(np.float32)
    masks = rng.uniform(size=(3, 6, 7)) > 0.5
    np.testing.assert_allclose(
        tfd.masked_mean_embedding(torch.tensor(feats), torch.tensor(masks)).numpy(),
        np.asarray(jfd.masked_mean_embedding(jnp.asarray(feats), jnp.asarray(masks))),
        atol=1e-6)


# ---------------------------------------------------------------------------
# the front end against roman_tpu's
# ---------------------------------------------------------------------------

FE_HW = (64, 96)


def _fe_params(**kw):
    base = dict(imgsz=FE_HW, seg_arch="tiny", vit_arch="tiny", max_masks_per_frame=8,
                max_points_per_mask=64, conf=0.0, min_mask_len_div=30, max_mask_len_div=1,
                triangle_ignore_masks=[[[80, 0], [95, 0], [95, 20]]],
                allow_tblr_edges=(True, True, True, False))
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def frontends():
    """roman_tpu's front end with seeded flax variables (FastSAM tiny in
    f32, the tiny DINOv2), and the port's with the same weights through
    the carrier; both run the same 2 frames of 64 x 96."""
    rng = np.random.default_rng(0)
    jseg = dataclasses.replace(jfastsam.TINY_TEST, dtype=jnp.float32)
    seg_vars = _seeded_flax_variables(jfastsam.YoloSeg(jseg), (1,) + FE_HW + (3,), rng)
    jvit_cfg = dataclasses.replace(jdinov2.DINOV2_SMALL, width=64, depth=2, heads=4,
                                   img_size=84, dtype=jnp.float32)
    vit_vars = _seeded_flax_variables(jdinov2.make_model(jvit_cfg), (1, 56, 84, 3), rng)
    jcam = JCamera.simple(width=96, height=64, f=60.0)
    jfe = jwrapper.PerceptionFrontend(JParams(**_fe_params()), jcam, seg_cfg=jseg,
                                      vit_cfg=jvit_cfg, seg_variables=seg_vars,
                                      vit_variables=vit_vars)
    images = rng.uniform(size=(2,) + FE_HW + (3,)).astype(np.float32)
    depths = rng.uniform(1.0, 8.5, size=(2,) + FE_HW).astype(np.float32)
    depths[:, :, :20] = 0.0                                         # no depth
    want = jfe.run_batch(images, depths)
    tfe = wrapper.PerceptionFrontend(
        FastSAMParams(**_fe_params()), CameraParams.simple(width=96, height=64, f=60.0),
        seg_cfg=dataclasses.replace(fastsam.TINY_TEST, dtype=torch.float32),
        seg_weights=convert.yoloseg_state_dict_from_flax(seg_vars),
        vit_weights=convert.vit_state_dict_from_flax(vit_vars), device="cpu")
    got = tfe.run_batch(images, depths)
    return dict(want=want, got=got, tfe=tfe, images=images, depths=depths)


def test_front_end_matches_roman_tpu(frontends):
    """valid equal; masks equal away from the knife edge; for every mask
    with no pixel on the knife edge, valid points within 1e-4 m and the
    embedding within 1e-5; frame descriptors within 1e-5.

    The knife edge: pixels whose mask logit lies within 1e-5 of 0. The two
    programs' logits differ by about 1e-8 here, and roman_tpu's jit fuses
    the threshold's sigmoid with them, so a pixel that close to 0 may fall
    either way; the lifted points and the mask-pooled embedding of its
    mask then differ. The counts are printed."""
    want, got, tfe = frontends["want"], frontends["got"], frontends["tfe"]
    B, K = want.valid.shape
    assert got.masks.shape == want.masks.shape == (B, K, 8, 12)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert 0 < want.valid.sum() < want.valid.size
    img, _ = tfe.inputs(frontends["images"], frontends["depths"])
    with torch.no_grad():
        out = tfe.seg_model(img)
        _, kb, _, km, _ = fastsam.select_proposals(out, tfe.seg_cfg, FE_HW, 0.0, 0.9, K)
        edge = fastsam.mask_logits(out["proto"], km, FE_HW).abs().numpy() < 1e-5
    clean = ~edge.reshape(B, K, -1).any(-1)
    print(f"knife-edge pixels: {int(edge.sum())} of {edge.size}; masks compared "
          f"point by point: {int(clean.sum())} of {B * K}")
    assert clean.sum() >= B * K // 2
    edge_ds = edge[..., ::8, ::8]
    np.testing.assert_array_equal(np.where(edge_ds, False, got.masks),
                                  np.where(edge_ds, False, want.masks))
    np.testing.assert_array_equal(got.points_valid[clean], want.points_valid[clean])
    pv = want.points_valid[clean][..., None]
    assert pv.sum() > 0
    np.testing.assert_allclose(np.where(pv, got.points[clean], 0),
                               np.where(pv, want.points[clean], 0), atol=1e-4)
    np.testing.assert_allclose(got.embeddings[clean], want.embeddings[clean], atol=1e-5)
    np.testing.assert_allclose(got.frame_descriptors, want.frame_descriptors, atol=1e-5)
    # segment_everything is the front end's segmentation in one call
    with torch.no_grad():
        masks, boxes, scores, keep = fastsam.segment_everything(tfe.seg_model, img, conf=0.0,
                                                                iou=0.9, max_masks=K)
        assembled = fastsam.assemble_masks(out["proto"], km, kb, FE_HW)
    np.testing.assert_array_equal(masks.numpy(), (assembled & keep[..., None, None]).numpy())
    np.testing.assert_array_equal(boxes.numpy(), kb.numpy())


def test_front_end_observations_and_one_frame_wrapper(frontends):
    from roman_tpu_torch.map.fastsam_wrapper import FastSAMWrapper

    tfe, got = frontends["tfe"], frontends["got"]
    obs = tfe.observations(got, [0.0, 0.5], [np.eye(4)] * 2)
    assert [len(o) for o in obs] == [int((got.valid[b] & got.points_valid[b].any(-1)).sum())
                                     for b in range(2)]
    for o in obs[0]:
        assert o.point_cloud.shape[1] == 3 and o.semantic_descriptor.shape == (64,)
        assert (o.point_cloud[:, 2] <= 7.5 + 1e-3).all()
    one = FastSAMWrapper.from_params(
        tfe.params, tfe.camera, seg_cfg=tfe.seg_cfg, device="cpu",
        seg_weights=tfe.seg_model.state_dict(), vit_weights=tfe.vit_model.state_dict())
    o1, fd = one.run(0.0, np.eye(4), frontends["images"][0], frontends["depths"][0])
    assert len(o1) == len(obs[0])
    np.testing.assert_allclose(fd, got.frame_descriptors[0], atol=1e-6)


def test_front_end_options_run_on_the_cpu(frontends):
    """Rotation, the YOLO label stand-in and CLIP crop semantics on the
    port's tiny front end: outputs in the camera frame, label filtering
    only removes, CLIP embeddings of unit norm on the valid slots and 0 on
    the others."""
    tfe = frontends["tfe"]
    images, depths = frontends["images"], frontends["depths"]
    cam = tfe.camera
    rot = wrapper.PerceptionFrontend(FastSAMParams(**_fe_params(rotate_img="CW")), cam,
                                     device="cpu").run_batch(images, depths)
    assert rot.masks.shape == (2, 8, 8, 12)
    base = wrapper.PerceptionFrontend(FastSAMParams(**_fe_params()), cam, device="cpu")
    yolo = wrapper.PerceptionFrontend(FastSAMParams(**_fe_params(ignore_people=True)), cam,
                                      device="cpu")
    assert yolo.run_yolo
    out_base, out_yolo = base.run_batch(images, depths), yolo.run_batch(images, depths)
    np.testing.assert_array_equal(out_base.masks, out_yolo.masks)
    assert (out_yolo.valid <= out_base.valid).all()
    clip_cfg = dataclasses.replace(clip.CLIP_VIT_B32, width=32, depth=1, heads=4, img_size=64,
                                   proj_dim=16, dtype=torch.float32)
    out = wrapper.PerceptionFrontend(FastSAMParams(**_fe_params(semantics="clip")), cam,
                                     clip_cfg=clip_cfg, device="cpu").run_batch(images, depths)
    assert out.embeddings.shape == (2, 8, 16) and out.valid.any()
    np.testing.assert_allclose(np.linalg.norm(out.embeddings[out.valid], axis=-1), 1.0,
                               atol=1e-5)
    assert not out.embeddings[~out.valid].any()


def test_checkpoint_round_trip(tmp_path, frontends):
    sd = frontends["tfe"].vit_model.state_dict()
    path = str(tmp_path / "ckpt" / "vit.pt")
    calls = []

    def convert_fn(src):
        calls.append(src)
        return sd

    first = checkpoints.load_or_convert(path, "upstream.pt", convert_fn)
    again = checkpoints.load_or_convert(path, "upstream.pt", convert_fn, like=sd)
    assert calls == ["upstream.pt"] and set(first) == set(again) == set(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k].cpu())
    with pytest.raises(ValueError, match="does not match"):
        checkpoints.load_params(path, like={"other": torch.zeros(1)})


# ---------------------------------------------------------------------------
# MapRunner.run with the port's own front end
# ---------------------------------------------------------------------------

def _archive(T=8, H=96, W=128):
    """tests/test_npz_mapping.py's frames: seeded uint8 images, depth 3 m
    with near boxes at 1.5 m, slow forward motion."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(T, H, W, 3)).astype(np.uint8)
    depths = np.full((T, H, W), 3.0, np.float32)
    depths[:, 30:60, 40:70] = 1.5
    times = np.arange(T) * 0.25
    poses = np.stack([np.eye(4)] * T)
    poses[:, 0, 3] = 0.2 * times
    return images, depths, times, poses


@pytest.mark.parametrize("backend", ["host", "device"])
def test_map_runner_runs_rgbd_frames_through_the_port_front_end(backend):
    """MapRunner.run with no front end passed builds the port's
    PerceptionFrontend on its device (test_npz_mapping.py's settings, but
    max_mask_len_div 1: a random net's boxes cover most of the image, and
    at 2 every mask is too large, so no observation would reach the
    mapper)."""
    from roman_tpu_torch.data.pose_data import PoseData
    from roman_tpu_torch.map.run import MapRunner
    from roman_tpu_torch.params.mapper_params import MapperParams

    images, depths, times, poses = _archive()
    fs = yaml.safe_load(yaml.dump({"imgsz": [96, 128], "seg_arch": "tiny", "vit_arch": "tiny",
                                   "batch_frames": 4, "max_masks_per_frame": 8,
                                   "max_points_per_mask": 64, "conf": 0.0,
                                   "min_mask_len_div": 40, "max_mask_len_div": 1}))
    mp = dict(min_sightings=1, max_t_no_sightings=2.0, geometric_score_range=(0.05, 1.0))
    if backend == "device":
        mp.update(mapper_backend="device", max_segments=64, max_points_per_segment=64)
    pd = PoseData.from_times_and_poses(times, poses)
    runner = MapRunner(MapperParams(**mp), FastSAMParams(**fs),
                       CameraParams.simple(width=128, height=96, f=100.0), pd, dt=0.25,
                       device="cpu")

    def get_frames(ts):
        idx = np.searchsorted(times, ts)
        return images[idx], depths[idx]

    roman_map = runner.run(get_frames)
    assert isinstance(runner.frontend, wrapper.PerceptionFrontend)
    assert runner.frontend.device.type == "cpu"
    n = len(roman_map.times)
    assert n >= len(times) - 1
    assert roman_map.trajectory.shape == (n, 4, 4)
    np.testing.assert_allclose(roman_map.trajectory[:, 0, 3], 0.2 * np.asarray(roman_map.times),
                               atol=1e-5)
    assert len(runner.times.total_times) == n
    assert len(roman_map.segments) > 0
    assert all(np.asarray(s.semantic_descriptor).shape == (64,) for s in roman_map.segments)
