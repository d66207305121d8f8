"""The port's map readers against roman_tpu's on the CPU: map pickles of
the reference mit-acl/roman (through roman_tpu_torch.interop), the
reference-format writers, RomanMap's pickle/concatenate/lookup helpers and
the segment-slam json readers."""

import os
import pickle
import types

import numpy as np
import pytest

from roman_tpu import interop as jinterop
from roman_tpu.map import roman_map as jmap
from roman_tpu.sim import world

from roman_tpu_torch import interop as tinterop
from roman_tpu_torch.align.results import _write_submap_jsons
from roman_tpu_torch.map import roman_map as tmap

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "reference_map_golden.pkl")


def _assert_maps_equal(a, b):
    """Field by field: segments, trajectory, times, descriptors."""
    assert len(a.segments) == len(b.segments)
    for sa, sb in zip(a.segments, b.segments):
        for name in ("id", "volume", "linearity", "planarity", "scattering",
                     "first_seen", "last_seen"):
            assert getattr(sa, name) == getattr(sb, name), name
        for name in ("center", "extent", "semantic_descriptor", "points"):
            va, vb = getattr(sa, name), getattr(sb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    np.testing.assert_array_equal(a.times, b.times)
    if a.descriptors is None:
        assert b.descriptors is None
    else:
        np.testing.assert_array_equal(a.descriptors, b.descriptors)
    assert a.poses_are_flu == b.poses_are_flu


def test_load_roman_map_reads_the_reference_golden_pickle():
    """The pickle names roman.map.map.ROMANMap and roman.object.segment
    classes; the port converts it as roman_tpu does, without importing
    the reference package."""
    port = tmap.load_roman_map(GOLDEN)
    ref = jmap.load_roman_map(GOLDEN)
    assert isinstance(port, tmap.RomanMap)
    assert [s.id for s in port.segments] == [10, 11, 12]
    _assert_maps_equal(port, ref)
    _assert_maps_equal(tinterop.load_reference_map(GOLDEN), ref)


def test_load_roman_map_reads_full_reference_segments(tmp_path, rng):
    """Reference Segments that carry points: the shape attributes are
    recomputed from the points, as roman_tpu does."""
    Segment = type("Segment", (), {"__module__": "roman.object.segment"})
    ROMANMap = type("ROMANMap", (), {"__module__": "roman.map.map"})
    segs = []
    for k in range(3):
        s = Segment.__new__(Segment)
        s.__dict__.update(id=k, points=rng.normal(size=(40, 3)) * [2.0, 1.0, 0.5],
                          semantic_descriptor=np.ones(4), first_seen=1.0 * k,
                          last_seen=2.0 + k, _center_ref="bottom_middle" if k else "mean")
        segs.append(s)
    m = ROMANMap.__new__(ROMANMap)
    m.__dict__.update(segments=segs, trajectory=[np.eye(4)] * 2, times=[0.0, 1.0])
    path = tmp_path / "ref_full.pkl"
    with tinterop._reference_module_scope():
        import sys
        for cls in (Segment, ROMANMap):
            setattr(sys.modules[cls.__module__], cls.__name__, cls)
        with open(path, "wb") as f:
            pickle.dump(m, f)
    _assert_maps_equal(tmap.load_roman_map(str(path)),
                       jinterop.load_reference_map(str(path)))


def _sim_maps(seed=3):
    _, runs = world.make_multi_robot_world(
        np.random.default_rng(seed), n_robots=2, n_objects=40,
        area=(20.0, 20.0, 3.0), traj_len=20.0, desc_dim=8)
    return [world.roman_map_from_run(r) for r in runs]


def test_save_reference_map_reads_back_in_roman_tpu(tmp_path):
    jm = _sim_maps()[0]
    jm.save(str(tmp_path / "tpu.pkl"))
    port = tmap.load_roman_map(str(tmp_path / "tpu.pkl"))
    tinterop.save_reference_map(port, str(tmp_path / "ref.pkl"))
    raw = (tmp_path / "ref.pkl").read_bytes()
    assert b"roman.map.map" in raw and b"roman_tpu" not in raw
    back = jinterop.load_reference_map(str(tmp_path / "ref.pkl"))
    jinterop.save_reference_map(jm, str(tmp_path / "ref_j.pkl"))
    ref = jinterop.load_reference_map(str(tmp_path / "ref_j.pkl"))
    _assert_maps_equal(back, ref)


def test_save_reference_align_results_matches_roman_tpu(tmp_path):
    from roman_tpu.align.results import SubmapAlignResults as JaxResults
    from roman_tpu.params.submap_align_params import (
        SubmapAlignInputOutput as JaxIO, SubmapAlignParams as JaxParams)
    from roman_tpu_torch.align.results import SubmapAlignResults
    from roman_tpu_torch.params.submap_align_params import (
        SubmapAlignInputOutput, SubmapAlignParams)

    fields = dict(
        robots_nearby_mat=np.full((2, 3), np.nan),
        clipper_angle_mat=np.zeros((2, 3)), clipper_dist_mat=np.zeros((2, 3)),
        clipper_num_associations=np.zeros((2, 3)), similarity_mat=None,
        submap_yaw_diff_mat=np.zeros((2, 3)),
        associated_objs_mat=[[np.zeros((0, 2), np.int64)] * 3] * 2,
        T_ij_mat=np.broadcast_to(np.eye(4), (2, 3, 4, 4)).copy(),
        T_ij_hat_mat=np.full((2, 3, 4, 4), np.nan), timing_list=[0.1] * 6,
        total_time=1.0)
    io = dict(inputs=["a.pkl", "b.pkl"], output_dir=str(tmp_path), run_name="align")
    tinterop.save_reference_align_results(
        SubmapAlignResults(submap_align_params=SubmapAlignParams(),
                           submap_io=SubmapAlignInputOutput(**io), **fields),
        str(tmp_path / "port.pkl"))
    jinterop.save_reference_align_results(
        JaxResults(submap_align_params=JaxParams(), submap_io=JaxIO(**io), **fields),
        str(tmp_path / "jax.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        port = jinterop._RefUnpickler(f).load()
    with open(tmp_path / "jax.pkl", "rb") as f:
        ref = jinterop._RefUnpickler(f).load()
    assert type(port).__module__ == "roman.align.results"
    assert port.submap_align_params.__dict__ == ref.submap_align_params.__dict__
    assert port.submap_io.__dict__ == ref.submap_io.__dict__
    np.testing.assert_array_equal(port.T_ij_mat, ref.T_ij_mat)


def test_from_pickle_concatenate_and_lookup_match_roman_tpu(tmp_path):
    jmaps = _sim_maps()
    paths = []
    for k, m in enumerate(jmaps):
        paths.append(str(tmp_path / f"m{k}.pkl"))
        m.save(paths[-1])
    ports = [tmap.RomanMap.from_pickle(p) for p in paths]
    for p, j in zip(ports, jmaps):
        _assert_maps_equal(p, j)
    both = tmap.RomanMap.concatenate(ports)
    ref = jmap.RomanMap.concatenate(jmaps)
    _assert_maps_equal(both, ref)
    for seg_id in (ref.segments[0].id, ref.segments[-1].id, -5):
        a, b = both.get_segment_by_id(seg_id), ref.get_segment_by_id(seg_id)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.center, b.center)
    # a pickle that holds no map is refused, and load_roman_map's fallback
    # then refuses it as a reference map too
    with open(tmp_path / "list.pkl", "wb") as f:
        pickle.dump([1, 2], f)
    with pytest.raises(TypeError, match="not a RomanMap"):
        tmap.RomanMap.from_pickle(str(tmp_path / "list.pkl"))
    with pytest.raises(AttributeError):
        tmap.load_roman_map(str(tmp_path / "list.pkl"))


def test_segment_slam_submaps_round_trip(tmp_path):
    """The port's *.sm.json writer, read back by both packages' readers."""
    jm = _sim_maps()[0]
    jm.save(str(tmp_path / "m.pkl"))
    port = tmap.load_roman_map(str(tmp_path / "m.pkl"))
    submaps = tmap.submaps_from_roman_map(
        port, tmap.SubmapParams(max_size=20, radius=15.0, distance=5.0))
    out = str(tmp_path / "robot0.sm.json")
    io = types.SimpleNamespace(output_submaps=[out], robot_names=["robot0"])
    _write_submap_jsons(types.SimpleNamespace(submap_io=io), [submaps], [port])

    sms = tmap.load_segment_slam_submaps(out, robot_name="robot0")
    ref = jmap.load_segment_slam_submaps(out, robot_name="robot0")
    assert len(sms) == len(submaps) == len(ref) >= 2
    for a, b, orig in zip(sms, ref, submaps):
        assert a.id == b.id and a.time == b.time and a.segment_frame == "odom"
        np.testing.assert_array_equal(a.pose_flu, b.pose_flu)
        np.testing.assert_allclose(a.pose_flu, orig.pose_gravity_aligned, atol=1e-9)
        assert [s.id for s in a.segments] == [s.id for s in orig.segments]
        for sa, sb in zip(a.segments, b.segments):
            np.testing.assert_array_equal(sa.center, sb.center)
            assert (sa.volume, sa.first_seen) == (sb.volume, sb.first_seen)
    segs = tmap.load_segment_slam_segments(out, as_dict=True)
    assert set(segs) == {s.id for s in port.segments}
    assert tmap.load_segment_slam_submaps(out, robot_name="robot1") == []
