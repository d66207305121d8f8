"""The port's per-pair registration classes against roman_tpu's, on the CPU.

ROMANRegistration (register, T_align, get_MCA, mno_clipper),
DistRegWithPruning (with its gravity check) and RansacReg on a rigid
6-object pair, ROMANRegistration on a 7 x 13 pair without descriptors,
the SubmapFeatures input, empty maps and too few associations. Limits:
associations equal, T_align within 1e-4, get_MCA's M and C within 1e-6
and A equal; RANSAC, whose draws differ by design, on outcomes. roman_tpu
runs at two shapes, 6 x 6 and 7 x 13. The one packer from objects to
features against roman_tpu's two (the grid's and the per-pair one),
tensor for tensor.
"""

import types

import numpy as np
import pytest
import torch

from roman_tpu.align import dist_reg_with_pruning as j_prune
from roman_tpu.align import object_registration as j_obj
from roman_tpu.align import ransac_reg as j_ransac
from roman_tpu.align import roman_registration as j_roman
from roman_tpu.align.registration import RegistrationConfig as JConfig
from roman_tpu.map import roman_map as j_map
from roman_tpu.map.roman_map import SegmentData as JSegment
from roman_tpu.sim import world as j_world
from roman_tpu_torch.align import dist_reg_with_pruning as t_prune
from roman_tpu_torch.align import object_registration as t_obj
from roman_tpu_torch.align import ransac_reg as t_ransac
from roman_tpu_torch.align import roman_registration as t_roman
from roman_tpu_torch.align.registration import RegistrationConfig, build_features
from roman_tpu_torch.map import roman_map as t_map
from roman_tpu_torch.map.roman_map import SegmentData as TSegment

torch.set_num_threads(1)

ROMAN = dict(gravity=True, volume=True, pca=True, semantics_dim=8)


def _rot(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def rigid_pair(R, t, seed=3):
    """The 6-object pair of tests/test_alias_packages.py: map2 is map1
    seen from the pose (R, t), as field dicts."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (6, 3))
    descs = np.eye(6, 8)

    def seg(i, c, d):
        return dict(id=i, center=c, volume=1.0 + 0.1 * i, linearity=0.5,
                    planarity=0.3, scattering=0.2, extent=np.array([1.0, 0.5, 0.2]),
                    semantic_descriptor=d)

    return ([seg(i, centers[i], descs[i]) for i in range(6)],
            [seg(i + 10, R.T @ (centers[i] - t), descs[i]) for i in range(6)])


YAW_R, YAW_T = _rot(2, 0.6), np.array([2.0, -1.0, 0.5])


def both(fields):
    """The same objects as roman_tpu's and the port's SegmentData."""
    return [JSegment(**f) for f in fields], [TSegment(**f) for f in fields]


@pytest.fixture(scope="module")
def pair():
    m1, m2 = rigid_pair(YAW_R, YAW_T)
    (j1, t1), (j2, t2) = both(m1), both(m2)
    return j1, j2, t1, t2


def _same_T(a, b):
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_roman_registration_matches_roman_tpu(pair):
    j1, j2, t1, t2 = pair
    jreg = j_roman.ROMANRegistration(j_roman.ROMANParams(**ROMAN))
    treg = t_roman.ROMANRegistration(t_roman.ROMANParams(**ROMAN), device="cpu")
    assert treg.params.fusion_method is t_roman.FusionMethod.GEOMETRIC_MEAN
    assert treg.cfg.method == jreg.cfg.method == "roman"
    assert treg.cfg.feature_flags == tuple(jreg.cfg.feature_flags)
    A, B = treg.register(t1, t2), jreg.register(j1, j2)
    np.testing.assert_array_equal(A, B)
    assert len(A) == 6 and all(i == j for i, j in A)
    T = treg.T_align(t1, t2, A)
    _same_T(T, jreg.T_align(j1, j2, B))
    _same_T(T[:3, :3], YAW_R)
    _same_T(T[:3, 3], YAW_T)
    _same_T(treg.T_align(t1, t2), T)  # registers when not given


def test_get_mca_and_mno_clipper_match_roman_tpu(pair):
    j1, j2, t1, t2 = pair
    jreg = j_roman.ROMANRegistration(j_roman.ROMANParams(**ROMAN))
    treg = t_roman.ROMANRegistration(t_roman.ROMANParams(**ROMAN), device="cpu")
    (M, C, A), (JM, JC, JA) = treg.get_MCA(t1, t2), jreg.get_MCA(j1, j2)
    assert M.shape == C.shape == (36, 36) and A.shape == (36, 2)
    np.testing.assert_allclose(M, JM, atol=1e-6)
    np.testing.assert_allclose(C, JC, atol=1e-6)
    np.testing.assert_array_equal(A, JA)
    got, ref = treg.mno_clipper(t1, t2, 2), jreg.mno_clipper(j1, j2, 2)
    assert len(got) == len(ref) == 2
    for (a, fa), (b, fb) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert abs(fa - fb) <= 1e-4 * max(1.0, abs(fb))


def test_dist_reg_with_pruning_matches_roman_tpu(pair):
    """Positional sigma and epsilon with the reference's keyword names
    (dist_reg_with_pruning.py:17-18); a roll beyond roll_pitch_thresh
    raises GravityConstraintError in both packages."""
    j1, j2, t1, t2 = pair
    kw = dict(cos_min=0.5, shape_epsilon=0.5)
    jreg = j_prune.DistRegWithPruning(0.3, 0.5, **kw)
    treg = t_prune.DistRegWithPruning(0.3, 0.5, **kw, device="cpu")
    A, B = treg.register(t1, t2), jreg.register(j1, j2)
    np.testing.assert_array_equal(A, B)
    assert len(A) >= 4 and all(i == j for i, j in A)
    _same_T(treg.T_align(t1, t2, A), jreg.T_align(j1, j2, B))
    _same_T(treg.T_align(t1, t2, A)[:3, 3], YAW_T)

    m1, m2 = rigid_pair(_rot(0, np.deg2rad(20.0)) @ YAW_R, YAW_T)
    (r1, s1), (r2, s2) = both(m1), both(m2)
    jg = j_prune.DistRegWithPruning(0.3, 0.5, use_gravity=True, **kw)
    tg = t_prune.DistRegWithPruning(0.3, 0.5, use_gravity=True, **kw, device="cpu")
    A, B = tg.register(s1, s2), jg.register(r1, r2)
    np.testing.assert_array_equal(A, B)
    with pytest.raises(t_prune.GravityConstraintError):
        tg.T_align(s1, s2, A)
    with pytest.raises(j_prune.GravityConstraintError):
        jg.T_align(r1, r2, B)
    with pytest.raises(AssertionError, match="Gravity"):
        t_prune.DistRegWithPruning(0.3, 0.5, dim=2, use_gravity=True, device="cpu")


def test_ransac_reg_matches_roman_tpu_on_outcomes(pair):
    """The triplets differ (host draws against JAX's PRNG); on this pair
    both find every association and the same transform."""
    j1, j2, t1, t2 = pair
    A = t_ransac.RansacReg(num_iterations=512, device="cpu").register(t1, t2, seed=0)
    B = j_ransac.RansacReg(num_iterations=512).register(j1, j2)
    np.testing.assert_array_equal(A, B)
    assert len(A) == 6 and all(i == j for i, j in A)
    reg = t_ransac.RansacReg(num_iterations=512, device="cpu")
    _same_T(reg.T_align(t1, t2, A)[:3, 3], YAW_T)
    np.testing.assert_array_equal(reg.register(t1, t2, seed=0), A)  # seeded


def test_7x13_pair_without_descriptors_matches_roman_tpu():
    """n != m and D = 0 (ROMANParams() has semantics_dim 0): the fused path
    with no cosine term on an unbatched pair."""
    rng = np.random.default_rng(11)
    c1 = rng.uniform(-8, 8, (7, 3)) * [1.0, 1.0, 0.2]
    R, t = _rot(2, -1.1), np.array([1.5, 0.5, -0.3])
    c2 = rng.uniform(-8, 8, (13, 3)) * [1.0, 1.0, 0.2]
    c2[3:10] = (c1 - t) @ R + rng.normal(scale=0.02, size=(7, 3))
    vol = rng.uniform(0.5, 3.0, 13)
    pca = rng.dirichlet(np.ones(3), 13)

    def fields(c, k0):
        return [dict(id=k0 + i, center=c[i], volume=float(vol[i]),
                     linearity=float(pca[i, 0]), planarity=float(pca[i, 1]),
                     scattering=float(pca[i, 2]), extent=np.ones(3))
                for i in range(len(c))]

    f2 = fields(c2, 100)
    f1 = [dict(f2[3 + i], id=i, center=c1[i]) for i in range(7)]
    (j1, t1), (j2, t2) = both(f1), both(f2)
    params = dict(gravity=True, volume=True, pca=True)
    jreg = j_roman.ROMANRegistration(j_roman.ROMANParams(**params))
    treg = t_roman.ROMANRegistration(t_roman.ROMANParams(**params), device="cpu")
    assert treg.cfg.method == "pcavolgrav"
    A, B = treg.register(t1, t2), jreg.register(j1, j2)
    np.testing.assert_array_equal(A, B)
    np.testing.assert_array_equal(A, np.stack([np.arange(7), np.arange(3, 10)], 1))
    T = treg.T_align(t1, t2, A)
    _same_T(T, jreg.T_align(j1, j2, B))
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-2)  # 2 cm of noise


def test_features_input_empty_maps_and_too_few_associations(pair):
    """SubmapFeatures as input (padded past the objects: get_MCA keeps the
    valid block), an empty side (no solve, np.array([[]])), and T_align's
    InsufficientAssociationsException."""
    j1, j2, t1, t2 = pair
    cfg = RegistrationConfig(method="clipper")
    reg = t_obj.ObjectRegistration(cfg, device="cpu")

    def feats(segs, cap):
        c = torch.zeros(cap, 3)
        c[:len(segs)] = torch.as_tensor(np.stack([s.center for s in segs]),
                                        dtype=torch.float32)
        return build_features(c, torch.arange(cap) < len(segs), cfg)

    f1, f2 = feats(t1, 8), feats(t2, 8)
    A = reg.register(f1, f2)
    np.testing.assert_array_equal(A, reg.register(t1, t2))
    np.testing.assert_array_equal(A, j_obj.ObjectRegistration(
        j_roman.RegistrationConfig(method="clipper")).register(j1, j2))
    _same_T(reg.T_align(f1, f2, A), reg.T_align(t1, t2, A))
    M, C, AA = reg.get_MCA(f1, f2)
    M0, C0, AA0 = reg.get_MCA(t1, t2)
    assert M.shape == (36, 36)
    np.testing.assert_array_equal(M, M0)
    np.testing.assert_array_equal(C, C0)
    np.testing.assert_array_equal(AA // 1, np.stack([AA0[:, 0], AA0[:, 1]], 1))

    for r in (reg, t_roman.ROMANRegistration(t_roman.ROMANParams(), device="cpu"),
              t_prune.DistRegWithPruning(0.4, 0.6, device="cpu"),
              t_ransac.RansacReg(device="cpu")):
        for a, b in (([], t2), (t1, [])):
            got = r.register(a, b)
            assert got.shape == (1, 0) and got.shape == j_obj.ObjectRegistration(
                j_roman.RegistrationConfig()).register([], j2).shape
    with pytest.raises(t_obj.InsufficientAssociationsException) as e:
        reg.T_align([], t2)
    assert (e.value.map1_len, e.value.map2_len) == (0, 6)
    with pytest.raises(t_obj.InsufficientAssociationsException) as e:
        reg.T_align(t1, t2, np.array([[0, 0], [1, 1]]))
    assert e.value.n_associations == 2


def test_prune_and_ransac_take_features_input(pair):
    """DistRegWithPruning and RansacReg take SubmapFeatures packed with
    their own cfg (here padded past the objects) as the base class does,
    with the associations of the object lists; the prune reads its shape
    attributes and descriptors from the features, and refuses features of
    another layout."""
    _, _, t1, t2 = pair
    prune = t_prune.DistRegWithPruning(0.3, 0.5, cos_min=0.5, shape_epsilon=0.5,
                                       device="cpu")
    ransac = t_ransac.RansacReg(num_iterations=512, device="cpu")
    for reg in (prune, ransac):
        f1, f2 = (t_obj.segments_to_features(s, reg.cfg, capacity=8, device="cpu")
                  for s in (t1, t2))
        A = reg.register(f1, f2)
        assert len(A) >= 4
        np.testing.assert_array_equal(A, reg.register(t1, t2))
    f1, f2 = (t_obj.segments_to_features(s, RegistrationConfig(method="clipper"),
                                         device="cpu") for s in (t1, t2))
    with pytest.raises(ValueError, match="its own cfg"):
        prune.register(f1, f2)


@pytest.fixture(scope="module")
def submaps(tmp_path_factory):
    """roman_tpu's and the port's submaps of one robot of a small sim world
    (32-d descriptors, at most 20 objects a submap), the port's from
    roman_tpu's map pickle."""
    _, runs = j_world.make_multi_robot_world(
        np.random.default_rng(7), n_robots=1, n_objects=150, area=(40.0, 40.0, 4.0),
        traj_len=40.0, desc_dim=32)
    path = str(tmp_path_factory.mktemp("pack") / "robot0.pkl")
    j_world.roman_map_from_run(runs[0]).save(path)
    kw = dict(max_size=20, radius=12.0, distance=10.0)
    return (j_map.submaps_from_roman_map(j_map.load_roman_map(path), j_map.SubmapParams(**kw)),
            t_map.submaps_from_roman_map(t_map.load_roman_map(path), t_map.SubmapParams(**kw)))


def _reference_like(seed=5):
    """Seven objects as the reference's minimal segments: linearity,
    planarity and scattering, extent None but on one, the first without a
    descriptor, and no id."""
    rng = np.random.default_rng(seed)
    objs = [types.SimpleNamespace(
        center=rng.uniform(-5, 5, 3), volume=float(rng.uniform(0.5, 3.0)),
        linearity=float(rng.uniform()), planarity=float(rng.uniform()),
        scattering=float(rng.uniform()), extent=None,
        semantic_descriptor=rng.normal(size=16)) for _ in range(7)]
    objs[0].semantic_descriptor = None
    objs[3].extent = rng.uniform(0.2, 2.0, 3)
    return objs


def _same_features(got, ref):
    for name in ("centers", "ratio_feats", "descriptors", "valid"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("method", ["roman", "sevg"])
@pytest.mark.parametrize("objects", ["submaps", "reference_like"])
def test_the_one_packer_matches_roman_tpus_two(objects, method, submaps):
    """submaps_to_features on a sim world's submaps (at capacity 20 and 32-d,
    and at the defaults) and segments_to_features on reference-like objects
    (at a capacity above their count, and at the default) pack what
    roman_tpu's do; a submap packed alone is its row of the grid's pack."""
    cfg, jcfg = RegistrationConfig(method=method), JConfig(method=method)
    if objects == "reference_like":
        objs = _reference_like()
        for cap in (10, None):
            got = t_obj.segments_to_features(objs, cfg, capacity=cap, device="cpu")
            _same_features(got, j_obj.segments_to_features(objs, jcfg, capacity=cap))
            assert got.capacity == (cap or 7) and got.descriptors.shape[-1] == 16
        return
    jsm, tsm = submaps
    assert len(tsm) >= 3 and max(map(len, tsm)) == 20
    for kw in ({}, dict(capacity=20, desc_dim=32)):
        f, aux = t_map.submaps_to_features(tsm, cfg, device="cpu", **kw)
        jf, jaux = j_map.submaps_to_features(jsm, jcfg, **kw)
        _same_features(f, jf)
        for key in ("times", "poses_flu", "poses_gravity", "positions", "seg_ids"):
            np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
    for k, sm in enumerate(tsm):  # f: the pack at capacity 20
        _same_features(t_obj.segments_to_features(sm.segments, cfg, capacity=20, device="cpu"),
                       f.map(lambda x: x[k]))
