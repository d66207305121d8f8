"""The port's mapping ops against roman_tpu's on the CPU, on the same
numpy-seeded inputs.

- voxel keys bitwise, at negative coordinates and far from the origin;
  sorted unique keys and both methods of voxel_iou_cross_keys exactly;
- voxel_downsample with capacity and coarsening: the same valid slots and
  voxel keys, points within 1e-5;
- statistical outlier masks and largest-cluster masks equal;
- the port's scipy DBSCAN twin equal to roman_tpu's scikit-learn twin;
- the auction's matches equal, ties included; the host Hungarian's pairs
  equal;
- geometry, metrics, camera projections and the range-sensor depth images
  within 1e-5 (extents, volumes and normalized eigenvalues on clouds with
  distinct principal axes, since eigenvector signs may differ);
- the object alias package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roman_tpu.ops import geometry as jgeo
from roman_tpu.ops import hungarian as jhun
from roman_tpu.ops import metrics as jmet
from roman_tpu.ops import pointcloud as jpc
from roman_tpu.ops import voxel as jvox

from roman_tpu_torch.ops import geometry as tgeo
from roman_tpu_torch.ops import hungarian as thun
from roman_tpu_torch.ops import metrics as tmet
from roman_tpu_torch.ops import pointcloud as tpc
from roman_tpu_torch.ops import voxel as tvox

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _clouds(seed, lead=4, n=50, scale=(3.0, 3.0, 1.0), offset=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(lead, n, 3)) * np.asarray(scale)
           + np.asarray(offset)).astype(np.float32)
    mask = rng.uniform(size=(lead, n)) < 0.9
    return pts, mask


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0), (-37.3, -0.01, -5.0),
                                    (1.0e4, -2.5e4, 3.0e3)],
                         ids=["origin", "negative", "far"])
@pytest.mark.parametrize("voxel_size", [0.05, 0.2, 0.25])
def test_voxel_keys_and_sorted_unique_keys_are_bitwise(offset, voxel_size):
    pts, mask = _clouds(1, offset=offset)
    pts[0] *= -1.0
    a = np.asarray(jvox.voxel_keys(_j(pts), _j(mask), voxel_size))
    b = tvox.voxel_keys(_t(pts), _t(mask), voxel_size).numpy()
    assert b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    ka, na = jvox.sorted_unique_keys(_j(pts), _j(mask), voxel_size)
    kb, nb = tvox.sorted_unique_keys(_t(pts), _t(mask), voxel_size)
    np.testing.assert_array_equal(np.asarray(ka), kb.numpy())
    np.testing.assert_array_equal(np.asarray(na), nb.numpy())


def test_voxel_key_of_invalid_hash_is_zero():
    """The hash is kept out of _INVALID, and padding is _INVALID."""
    pts = _t(np.zeros((1, 2, 3), np.float32))
    keys = tvox.voxel_keys(pts, torch.tensor([[True, False]]), 0.2)
    assert keys[0, 1] == tvox._INVALID and keys[0, 0] != tvox._INVALID


@pytest.mark.parametrize("iom", [False, True])
def test_voxel_iou_cross_keys_both_methods_equal_roman_tpu(iom):
    p1, m1 = _clouds(2, lead=5, n=40, scale=(0.6, 0.6, 0.6))
    p2 = p1[:3] + np.float32(0.07)
    m2 = m1[:3]
    k1, n1 = tvox.sorted_unique_keys(_t(p1), _t(m1), 0.2)
    k2, n2 = tvox.sorted_unique_keys(_t(p2), _t(m2), 0.2)
    ref = {}
    for method in ("compare", "searchsorted"):
        a = np.asarray(jvox.voxel_iou_cross_keys(
            _j(k1.numpy()), _j(n1.numpy()), _j(k2.numpy()), _j(n2.numpy()),
            iom_as_iou=iom, method=method))
        b = tvox.voxel_iou_cross_keys(k1, n1, k2, n2, iom_as_iou=iom,
                                      method=method).numpy()
        np.testing.assert_array_equal(a, b)
        ref[method] = b
    np.testing.assert_array_equal(ref["compare"], ref["searchsorted"])
    assert (ref["compare"] > 0).any()
    a = np.asarray(jvox.voxel_iou_cross(_j(p1), _j(m1), _j(p2), _j(m2), 0.2,
                                        iom_as_iou=iom))
    b = tvox.voxel_iou_cross(_t(p1), _t(m1), _t(p2), _t(m2), 0.2, iom_as_iou=iom)
    np.testing.assert_array_equal(a, b.numpy())
    a = np.asarray(jvox.voxel_iou_points(_j(p1[:3]), _j(m1[:3]), _j(p2), _j(m2), 0.2,
                                         iom_as_iou=iom))
    b = tvox.voxel_iou_points(_t(p1[:3]), _t(m1[:3]), _t(p2), _t(m2), 0.2,
                              iom_as_iou=iom)
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("capacity,levels", [(None, 0), (40, 0), (40, 2), (12, 2)])
def test_voxel_downsample_matches_roman_tpu(capacity, levels):
    p, m = _clouds(3, lead=3, n=200, scale=(0.3, 0.3, 0.3), offset=(-4.0, 7.0, 1.0))
    fn = jax.jit(lambda p, m: jvox.voxel_downsample(
        p, m, 0.05, capacity=capacity, max_coarsen_levels=levels))
    a, am = fn(_j(p), _j(m))
    b, bm = tvox.voxel_downsample(_t(p), _t(m), 0.05, capacity=capacity,
                                  max_coarsen_levels=levels)
    np.testing.assert_array_equal(np.asarray(am), bm.numpy())
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
    # the same voxel sets
    np.testing.assert_array_equal(
        np.asarray(jvox.voxel_keys(a, am, 0.05)),
        tvox.voxel_keys(b, bm, 0.05).numpy())


def test_voxel_numpy_twins_equal_roman_tpu():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(300, 3)) * 0.5 - 3.0
    b = a + 0.03
    assert tvox.voxel_set(a, 0.1) == jvox.voxel_set(a, 0.1)
    for iom in (False, True):
        assert tvox.voxel_iou_np(a, b, 0.1, iom) == jvox.voxel_iou_np(a, b, 0.1, iom)
    np.testing.assert_array_equal(tvox.voxel_downsample_np(a, 0.1),
                                  jvox.voxel_downsample_np(a, 0.1))


@pytest.mark.parametrize("std_ratio", [1.0, 2.0])
def test_statistical_outlier_masks_equal_roman_tpu(std_ratio):
    p, m = _clouds(5, lead=3, n=120, scale=(0.3, 0.3, 0.3))
    p[:, :5] += np.float32(3.0)           # far stragglers
    p[1, 10] = p[1, 11]                   # a duplicate (zero average)
    fn = jax.jit(lambda p, m: jpc.statistical_outlier_mask(p, m, 10, std_ratio))
    a = np.asarray(fn(_j(p), _j(m)))
    b = tpc.statistical_outlier_mask(_t(p), _t(m), 10, std_ratio).numpy()
    np.testing.assert_array_equal(a, b)
    assert a.sum() < m.sum()
    for k in range(3):
        x = p[k][m[k]].astype(np.float64)
        np.testing.assert_array_equal(tpc.statistical_outlier_mask_np(x, 10, std_ratio),
                                      jpc.statistical_outlier_mask_np(x, 10, std_ratio))


def _blobs(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(30, 3)) * 0.08,
                           rng.normal(size=(20, 3)) * 0.08 + np.array([0.9, 0.0, 0.0]),
                           rng.uniform(-2, 2, (8, 3))]).astype(np.float32)


@pytest.mark.parametrize("adaptive", [None, 1.6])
def test_largest_cluster_masks_equal_roman_tpu(adaptive):
    pts = np.stack([_blobs(s) for s in range(3)])
    pts[2] *= 4.0                          # coarse spacing: noise at eps
    mask = np.ones(pts.shape[:2], bool)
    mask[1, -3:] = False
    fn = jax.jit(lambda p, m: jpc.largest_cluster_mask(
        p, m, eps=0.25, adaptive_spacing_factor=adaptive))
    a = np.asarray(fn(_j(pts), _j(mask)))
    b = tpc.largest_cluster_mask(_t(pts), _t(mask), eps=0.25,
                                 adaptive_spacing_factor=adaptive).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scipy_dbscan_twin_equals_the_sklearn_twin(seed):
    """Labels (clusters numbered by their lowest core index, a border point
    in the lowest cluster with a core within eps) and the keep-mask."""
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(60, 3)) * 0.2,
                        rng.normal(size=(40, 3)) * 0.2 + np.array([0.8, 0.0, 0.0]),
                        rng.uniform(-3, 3, (15, 3))])
    np.testing.assert_array_equal(
        tpc.dbscan_labels_np(x, 0.25, 10),
        DBSCAN(eps=0.25, min_samples=10).fit(x).labels_)
    np.testing.assert_array_equal(tpc.largest_cluster_mask_np(x, 0.25, 10),
                                  jpc.largest_cluster_mask_np(x, 0.25, 10))
    # all noise: everything kept; empty: nothing
    sparse = rng.uniform(-50, 50, (20, 3))
    np.testing.assert_array_equal(tpc.largest_cluster_mask_np(sparse),
                                  jpc.largest_cluster_mask_np(sparse))
    assert tpc.largest_cluster_mask_np(np.zeros((0, 3))).shape == (0,)


def test_auction_matches_roman_tpu_with_ties():
    rng = np.random.default_rng(6)
    ben = rng.uniform(-0.2, 1.0, (3, 7, 5)).astype(np.float32)
    ben[0, 1] = ben[0, 0]                  # two rows with the same bids
    ben[1, :, 2] = ben[1, :, 3]            # two equal columns
    ben[2] = 0.5                           # every entry tied
    rm = np.ones((3, 7), bool)
    rm[0, 6] = False
    cm = np.ones((3, 5), bool)
    cm[1, 4] = False
    a = np.asarray(jhun.auction_assignment(_j(ben), _j(rm), _j(cm), n_iters=64))
    b = thun.auction_assignment(_t(ben), _t(rm), _t(cm), n_iters=64).numpy()
    np.testing.assert_array_equal(a, b)
    assert (b >= 0).sum() >= 10
    cost = np.where(ben[0] > 0.3, -ben[0], 1e9).astype(np.float64)
    assert (thun.assignment_with_rejection_np(cost)
            == jhun.assignment_with_rejection_np(cost))
    assert thun.assignment_with_rejection_np(np.zeros((0, 3))) == []


def _anisotropic(seed, lead=3, n=60):
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pts = (rng.normal(size=(lead, n, 3)) * np.array([1.5, 0.6, 0.2])) @ R.T + 2.0
    mask = rng.uniform(size=(lead, n)) < 0.85
    mask[-1, 4:] = False                   # a row with 4 points: below the guard
    return pts.astype(np.float32), mask


def test_geometry_matches_roman_tpu():
    p, m = _anisotropic(7)
    tol = dict(rtol=0, atol=1e-5)
    for name in ("masked_mean", "masked_covariance", "shape_attributes"):
        np.testing.assert_allclose(getattr(tgeo, name)(_t(p), _t(m)).numpy(),
                                   np.asarray(getattr(jgeo, name)(_j(p), _j(m))), **tol)
    cov = jgeo.masked_covariance(_j(p), _j(m))
    e_j = np.asarray(jgeo.normalized_eigenvalues(cov))
    e_t = tgeo.normalized_eigenvalues(_t(np.asarray(cov))).numpy()
    np.testing.assert_allclose(e_t, e_j, **tol)
    np.testing.assert_allclose(
        tgeo.shape_attributes_from_eigenvalues(_t(e_j)).numpy(),
        np.asarray(jgeo.shape_attributes_from_eigenvalues(_j(e_j))), **tol)
    cj, aj, xj = jgeo.pca_obb(_j(p), _j(m))
    ct, at, xt = tgeo.pca_obb(_t(p), _t(m))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **tol)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)
    # axes agree up to sign
    np.testing.assert_allclose(np.abs(np.sum(at.numpy() * np.asarray(aj), -1)), 1.0, atol=1e-5)
    vj, ej = jgeo.obb_volume_extent(_j(p), _j(m))
    vt, et = tgeo.obb_volume_extent(_t(p), _t(m))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **tol)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **tol)
    assert vt[-1] == 0.0
    lo_j, hi_j = jgeo.aabb(_j(p), _j(m))
    lo_t, hi_t = tgeo.aabb(_t(p), _t(m))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(
        tgeo.aabb_intersects(lo_t[:, None], hi_t[:, None], lo_t[None], hi_t[None] - 3.0).numpy(),
        np.asarray(jgeo.aabb_intersects(lo_j[:, None], hi_j[:, None], lo_j[None],
                                        hi_j[None] - 3.0)))
    xy = np.random.default_rng(8).normal(size=(40, 2))
    np.testing.assert_array_equal(tgeo.convex_hull_2d(xy), jgeo.convex_hull_2d(xy))


def test_metrics_match_roman_tpu():
    p, m = _anisotropic(9)
    q = p[::-1].copy() + np.float32(0.3)
    mq = m[::-1].copy()
    m0 = m.copy()
    m0[1] = False                          # an empty cloud
    tol = dict(rtol=1e-5, atol=1e-5)
    for fn in ("chamfer_distance", "norm_chamfer_similarity"):
        for ma, mb in ((m, mq), (m0, mq), (m0, m0)):
            np.testing.assert_allclose(
                getattr(tmet, fn)(_t(p), _t(ma), _t(q), _t(mb)).numpy(),
                np.asarray(getattr(jmet, fn)(_j(p), _j(ma), _j(q), _j(mb))), **tol)
    cov1 = np.asarray(jgeo.masked_covariance(_j(p), _j(m)))
    cov2 = np.asarray(jgeo.masked_covariance(_j(q), _j(mq)))
    mu1, mu2 = p.mean(1), q.mean(1)
    # rows of full rank: the 4-point row's covariance is singular, where the
    # square root of its ~1e-8 eigenvalue leaves f32 results ~4e-4 apart
    # (and each that far from float64)
    cov1, cov2, mu1, mu2 = cov1[:2], cov2[1:], mu1[:2], mu2[1:]
    np.testing.assert_allclose(
        tmet.wasserstein_metric(_t(mu1), _t(cov1), _t(mu2), _t(cov2)).numpy(),
        np.asarray(jmet.wasserstein_metric(_j(mu1), _j(cov1), _j(mu2), _j(cov2))),
        rtol=1e-4, atol=1e-4)
    a = np.random.default_rng(10).normal(size=(5, 16)).astype(np.float32)
    a[2] = 0.0
    np.testing.assert_allclose(tmet.cosine_similarity(_t(a), _t(a[::-1].copy())).numpy(),
                               np.asarray(jmet.cosine_similarity(_j(a), _j(a[::-1]))),
                               **tol)


def test_camera_projections_match_roman_tpu():
    from roman_tpu.data import camera as jcam

    from roman_tpu_torch.data import camera as tcam

    cam_j = jcam.CameraParams.simple(64, 48, f=40.0)
    cam_t = tcam.CameraParams.simple(64, 48, f=40.0)
    np.testing.assert_array_equal(cam_t.K, cam_j.K)
    assert (cam_t.fx, cam_t.fy, cam_t.cx, cam_t.cy) == (cam_j.fx, cam_j.fy, cam_j.cx, cam_j.cy)
    K = cam_t.K.astype(np.float32)
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(2, 30, 3)) + np.array([0, 0, 4.0])).astype(np.float32)
    np.testing.assert_allclose(tcam.xyz_to_pixel(_t(pts), _t(K)).numpy(),
                               np.asarray(jcam.xyz_to_pixel(_j(pts), _j(K))), atol=1e-5)
    depth = rng.uniform(0.5, 5.0, (48, 64)).astype(np.float32)
    np.testing.assert_allclose(tcam.depth_image_to_points(_t(depth), _t(K)).numpy(),
                               np.asarray(jcam.depth_image_to_points(_j(depth), _j(K))),
                               atol=1e-5)


def test_range_sensor_depth_images_match_roman_tpu():
    from roman_tpu.data.camera import CameraParams as JCam
    from roman_tpu.data.pose_data import PoseData as JPD
    from roman_tpu.map.align_pointcloud import AlignPointCloud as JAlign

    from roman_tpu_torch.data.camera import CameraParams as TCam
    from roman_tpu_torch.data.pose_data import PoseData as TPD
    from roman_tpu_torch.map.align_pointcloud import AlignPointCloud as TAlign
    from roman_tpu_torch.sim.world import yaw_T

    rng = np.random.default_rng(12)
    T_cr = np.array([[0, -1, 0, 0], [0, 0, -1, 0.1], [1, 0, 0, 0], [0, 0, 0, 1.0]])
    times = np.arange(5) * 0.1
    poses = np.stack([yaw_T(0.05 * k, np.array([0.2 * k, 0.0, 0.0])) for k in range(5)])
    pts = (rng.uniform(-1, 1, (2, 400, 3)) * np.array([1.0, 3.0, 1.0])
           + np.array([4.0, 0.0, 0.0])).astype(np.float32)
    valid = rng.uniform(size=(2, 400)) < 0.9
    a = JAlign(JCam.simple(32, 24, f=20.0), T_cr, JPD.from_times_and_poses(times, poses))
    b = TAlign(TCam.simple(32, 24, f=20.0), T_cr, TPD.from_times_and_poses(times, poses),
               device="cpu")
    da = a.depth_images(pts, valid, [0.1, 0.2], [0.15, 0.3])
    db = b.depth_images(pts, valid, [0.1, 0.2], [0.15, 0.3])
    assert (db > 0).sum() > 50
    np.testing.assert_array_equal(da > 0, db > 0)
    np.testing.assert_allclose(db, da, rtol=0, atol=1e-5)


def test_object_package_aliases():
    """As tests/test_alias_packages.py::test_object_package_aliases."""
    from roman_tpu_torch.map.objects import ObjectBase, PointCloudObject
    from roman_tpu_torch.map.roman_map import SegmentData
    from roman_tpu_torch.object import (Ellipsoid, MeshObject, Object,  # noqa: F401
                                        PointCloudObject as PCO, Polytope, Segment,
                                        SegmentMinimalData)
    from roman_tpu_torch.object.object import Object as O2
    from roman_tpu_torch.object.segment import SegmentMinimalData as SMD
    from roman_tpu_torch.object.similiarity_metrics import ChamferDistance, Wasserstein

    assert Object is ObjectBase and O2 is ObjectBase and PCO is PointCloudObject
    assert SegmentMinimalData is SegmentData and SMD is SegmentData
    assert callable(ChamferDistance) and callable(Wasserstein)
    from roman_tpu.map.objects import PointCloudObject as JPCO

    pts = np.random.default_rng(13).normal(size=(200, 3))
    assert PointCloudObject(pts).volume == JPCO(pts).volume
