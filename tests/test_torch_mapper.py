"""The port's mapping stage against roman_tpu's on the CPU, on the same
numpy-seeded streams.

- the host Mapper: the same segments (ids, lifecycle lists, points equal)
  and the same map, with the empty-frame and graveyard rules;
- the device BatchMapper run on the CPU: per pool slot the same seg_id,
  status and num_sightings, points within 1e-5, the same spilled segments
  and the same exported map (geometry within 1e-5);
- the merge loop (a fixed number of iterations with a stop flag on the
  device) on a world that needs chained merges within one frame;
- spill of graveyard segments on a long stream;
- MapRunner.run_observations with both backends;
- roman_tpu.map.roman_map.load_roman_map reading the port's map pickles,
  field by field;
- the observation streams: sim_observation_source is demo/mapping.py's,
  mapping_bench_stream is bench.py's.

Two roman_tpu BatchMapper programs are compiled in this file (the stream
and the chained-merge world).
"""

import numpy as np
import pytest
import torch

from roman_tpu.data.camera import CameraParams as JCam
from roman_tpu.map import roman_map as jrm
from roman_tpu.map.batch_mapper import BatchMapper as JBatchMapper
from roman_tpu.map.mapper import Mapper as JMapper
from roman_tpu.map.observation import Observation as JObs
from roman_tpu.params.mapper_params import MapperParams as JParams

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.map.batch_mapper import GRAVEYARD, BatchMapper
from roman_tpu_torch.map.mapper import Mapper
from roman_tpu_torch.map.observation import Observation
from roman_tpu_torch.map.run import MapRunner
from roman_tpu_torch.params.fastsam_params import FastSAMParams
from roman_tpu_torch.params.mapper_params import MapperParams
from roman_tpu_torch.sim.observations import (mapping_bench_stream,
                                              stream_observations)
from roman_tpu_torch.sim.world import yaw_T

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host mappers' numpy products on one thread, as torch's."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield

# the stream: 20 objects over 24 m passed at 6 m/s (1 m a frame)
STREAM = dict(n_frames=24, obs_per_frame=10, pts_per_obs=40, desc_dim=16,
              seed=3, n_objects=20, length=24.0, speed=6.0)
# lifecycle settings under which tracks go inactive, retire and spill
LIFECYCLE = dict(min_sightings=2, max_t_no_sightings=0.4,
                 geometric_score_range=(0.1, 1.0), segment_graveyard_dist=4.0,
                 max_segments=32, max_points_per_segment=64)


def _stream():
    times, poses, pts, val, desc, mask = mapping_bench_stream(**STREAM)
    # two empty frames: lifecycle no-ops in both mappers
    mask[7] = False
    val[7] = False
    mask[15] = False
    val[15] = False
    return times, poses, pts, val, desc, mask


def _assert_segment_data_equal(a, b, atol=0.0):
    assert a.id == b.id
    for name in ("first_seen", "last_seen"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("volume", "linearity", "planarity", "scattering"):
        assert abs(getattr(a, name) - getattr(b, name)) <= atol, name
    for name in ("center", "extent", "semantic_descriptor", "points"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_allclose(np.asarray(va), np.asarray(vb), rtol=0,
                                       atol=atol, err_msg=name)


def _assert_maps_equal(a, b, atol=0.0):
    assert [s.id for s in a.segments] == [s.id for s in b.segments]
    for sa, sb in zip(a.segments, b.segments):
        _assert_segment_data_equal(sa, sb, atol)
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    np.testing.assert_array_equal(a.times, b.times)
    assert (a.descriptors is None) == (b.descriptors is None)
    if a.descriptors is not None:
        np.testing.assert_array_equal(a.descriptors, b.descriptors)
    assert a.poses_are_flu == b.poses_are_flu


# ---------------------------------------------------------------------------
# the host Mapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["default", "iom_semantic"])
def test_host_mapper_matches_roman_tpu(config):
    """Default params (the 2D-IOU merge test on reprojected masks is on),
    and iom with cosine association. The stream has empty frames, and its
    tracks retire to the graveyard by the distance rule."""
    kw = dict(LIFECYCLE)
    if config == "iom_semantic":
        kw.update(geometric_association_method="iom", semantic_association_method="cosine",
                  semantic_score_range=(0.5, 1.0), min_2d_iou=None)
    times, poses, pts, val, desc, mask = _stream()
    frames = stream_observations(times, poses, pts, val, desc, mask)
    port = Mapper(MapperParams(**kw), CameraParams.simple(64, 48, f=40.0))
    ref = JMapper(JParams(**kw), JCam.simple(64, 48, f=40.0))
    for f, obs in enumerate(frames):
        jobs = [JObs(time=o.time, pose=o.pose, point_cloud=o.point_cloud,
                     semantic_descriptor=o.semantic_descriptor) for o in obs]
        port.update(float(times[f]), poses[f], obs, frame_descriptor=np.ones(4))
        ref.update(float(times[f]), poses[f], jobs, frame_descriptor=np.ones(4))
        for name in ("segment_nursery", "segments", "inactive_segments",
                     "segment_graveyard"):
            pa, ra = getattr(port, name), getattr(ref, name)
            assert [s.id for s in pa] == [s.id for s in ra], (f, name)
            for s, r in zip(pa, ra):
                np.testing.assert_array_equal(s.points, r.points)
                assert s.num_sightings == r.num_sightings
    assert len(port.segment_graveyard) > 0
    assert port.id_counter == ref.id_counter > 10
    _assert_maps_equal(port.get_roman_map(), ref.get_roman_map())


def test_host_mapper_rules_for_empty_frames_and_graveyard():
    """An empty frame is a no-op beyond the history (67053c9); an inactive
    segment retires by the robot's distance from its pose at the segment's
    last observation, not from its center (55583e0)."""
    rng = np.random.default_rng(4)
    params = MapperParams(min_sightings=1, max_t_no_sightings=0.3,
                          segment_graveyard_dist=10.0, segment_graveyard_time=1e9,
                          geometric_score_range=(0.1, 1.0))
    m = Mapper(params, CameraParams.simple())
    target = np.array([15.0, 0.0, 1.0])
    t = 0.0
    for f in range(8):
        pose = yaw_T(0.0, np.array([1.6 * f, 0.0, 0.0]))
        Ti = np.linalg.inv(pose)
        centers = [np.array([1.6 * f + 2.0, 5.0, 1.0])] + ([target] if f == 0 else [])
        obs = [Observation(time=t, pose=pose,
                           point_cloud=(c + rng.normal(size=(30, 3)) * 0.1) @ Ti[:3, :3].T
                           + Ti[:3, 3]) for c in centers]
        m.update(t, pose, obs)
        t += 0.2
    far = [s for s in m.segment_graveyard
           if np.linalg.norm(s.center - target) < 1.0]
    assert len(far) == 1
    before = [(s.id, s.num_sightings) for s in m.segments + m.segment_nursery]
    n_inactive = len(m.inactive_segments)
    m.update(t + 5.0, pose, [])
    assert [(s.id, s.num_sightings) for s in m.segments + m.segment_nursery] == before
    assert len(m.inactive_segments) == n_inactive and len(m.times_history) == 9


# ---------------------------------------------------------------------------
# the device BatchMapper on the CPU
# ---------------------------------------------------------------------------

def _feed(mapper, stream, batch=6):
    times, poses, pts, val, desc, mask = stream
    for s in range(0, len(times), batch):
        e = s + batch
        mapper.update_batch(times[s:e], poses[s:e], pts[s:e], val[s:e], desc[s:e],
                            mask[s:e], frame_descriptors=[np.ones(4)] * len(times[s:e]))


def _assert_states_equal(ref, port):
    for name in ("seg_id", "status", "num_sightings", "points_valid", "vox_keys",
                 "vox_n", "next_id"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).cpu().numpy(), err_msg=name)
    for name in ("points", "descriptors", "desc_count", "first_seen", "last_seen",
                 "last_obs_pos"):
        np.testing.assert_allclose(getattr(port, name).cpu().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def batch_maps():
    """roman_tpu's and the port's BatchMapper over the same stream, with
    an occupancy check every 2 batches, so graveyard segments spill."""
    stream = _stream()
    port = BatchMapper(MapperParams(**LIFECYCLE), CameraParams.simple(), desc_dim=16,
                       obs_capacity=STREAM["obs_per_frame"], device="cpu")
    ref = JBatchMapper(JParams(**LIFECYCLE), JCam.simple(), desc_dim=16,
                       obs_capacity=STREAM["obs_per_frame"])
    for m in (port, ref):
        m.spill_check_every = 2
        m.spill_threshold = 0.0
    _feed(port, stream)
    _feed(ref, stream)
    return port, ref


def test_batch_mapper_matches_roman_tpu_per_slot(batch_maps):
    port, ref = batch_maps
    _assert_states_equal(ref.state, port.state)
    status = port.state.status.numpy()
    assert (status > 0).sum() >= 5 and int(port.state.next_id) > 15
    assert len(port._spilled) == len(ref._spilled) > 0
    for a, b in zip(port._spilled, ref._spilled):
        _assert_segment_data_equal(a, b, atol=1e-5)


def test_batch_mapper_exports_roman_tpu_map(batch_maps, tmp_path):
    """The exported map (cleanup, geometry, the spilled segments first),
    and roman_tpu's loader reading the port's pickle of it."""
    port, ref = batch_maps
    pm, rm = port.get_roman_map(), ref.get_roman_map()
    assert len(pm.segments) > 10
    _assert_maps_equal(pm, rm, atol=1e-5)
    path = str(tmp_path / "robot0.pkl")
    pm.save(path)
    read = jrm.load_roman_map(path)
    assert type(read) is jrm.RomanMap and type(read.segments[0]) is jrm.SegmentData
    _assert_maps_equal(read, pm)


def test_merge_loop_collapses_a_chain_in_one_frame():
    """Three spots, then one wide observation over all three: the merges
    chain (a~b, then ab~c) within the frame, as roman_tpu's while_loop
    does, leaving one live segment in the same slot with the same points."""
    kw = dict(min_sightings=1, max_t_no_sightings=10.0, geometric_score_range=(0.15, 1.0),
              geometric_association_method="iom", iou_voxel_size=0.25,
              segment_voxel_size=0.15, max_segments=8, max_points_per_segment=64)
    rng = np.random.default_rng(5)
    spots = [np.array([2.0, y, 1.0]) for y in (-1.2, 0.0, 1.2)]
    first = np.zeros((2, 4, 64, 3), np.float32)
    valid = np.zeros((2, 4, 64), bool)
    for k, c in enumerate(spots):
        first[0, k, :30] = c + rng.normal(size=(30, 3)) * 0.15
        valid[0, k, :30] = True
    wide = np.concatenate([c + rng.normal(size=(12, 3)) * 0.15 for c in spots]
                          + [np.stack([np.full(24, 2.0), np.linspace(-1.2, 1.2, 24),
                                       np.full(24, 1.0)], axis=1)])
    first[1, 0, :60] = wide
    valid[1, 0, :60] = True
    mask = valid.any(-1)
    desc = np.zeros((2, 4, 4), np.float32)
    poses = np.stack([np.eye(4)] * 2)
    port = BatchMapper(MapperParams(**kw), CameraParams.simple(), desc_dim=4,
                       obs_capacity=4, device="cpu")
    ref = JBatchMapper(JParams(**kw), JCam.simple(), desc_dim=4, obs_capacity=4)
    for m in (port, ref):
        m.update_batch([0.0], poses[:1], first[:1], valid[:1], desc[:1], mask[:1])
    assert int((port.state.status > 0).sum()) == 3
    for m in (port, ref):
        m.update_batch([0.1], poses[1:], first[1:], valid[1:], desc[1:], mask[1:])
    assert int((port.state.status > 0).sum()) == 1
    _assert_states_equal(ref.state, port.state)


def test_graveyard_segments_spill_off_the_pool():
    """A long stream of fresh objects: graveyard segments leave the pool,
    so the map grows past max_segments with unique ids."""
    rng = np.random.default_rng(6)
    params = MapperParams(min_sightings=1, max_t_no_sightings=0.3,
                          geometric_score_range=(0.15, 1.0), segment_graveyard_dist=6.0,
                          max_segments=24, max_points_per_segment=32)
    m = BatchMapper(params, CameraParams.simple(), desc_dim=4, obs_capacity=8,
                    device="cpu")
    m.spill_check_every = 2
    n_frames, per_frame = 20, 6
    for f in range(n_frames):
        t = f * 0.2
        pose = yaw_T(0.0, np.array([3.0 * f, 0.0, 0.0]))
        Ti = np.linalg.inv(pose)
        obs = [Observation(time=t, pose=pose, point_cloud=(
            np.array([3.0 * f, 4.0 * k, 1.0]) + rng.normal(size=(20, 3)) * 0.1)
            @ Ti[:3, :3].T + Ti[:3, 3]) for k in range(per_frame)]
        m.update(t, pose, obs)
    assert (m.state.status == GRAVEYARD).sum() < params.max_segments
    segs = m.get_roman_map().segments
    assert len(segs) > params.max_segments
    assert len(segs) >= n_frames * per_frame * 0.8
    assert len({s.id for s in segs}) == len(segs)


def test_ensure_desc_dim_widens_the_pool():
    p = MapperParams(max_segments=16, max_points_per_segment=32, min_sightings=1,
                     max_t_no_sightings=10.0)
    bm = BatchMapper(p, CameraParams.simple(64, 48), desc_dim=8, obs_capacity=4,
                     device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (1, 4, 8, 3)).astype(np.float32)
    val = np.ones((1, 4, 8), bool)
    mask = np.ones((1, 4), bool)
    bm.update_batch([0.0], np.eye(4)[None], pts, val, np.zeros((1, 4, 8), np.float32), mask)
    d32 = rng.normal(size=(1, 4, 32)).astype(np.float32)
    bm.update_batch([0.5], np.eye(4)[None], pts, val, d32, mask)
    assert bm.desc_dim == 32 and bm.state.descriptors.shape[-1] == 32
    assert bm.state.descriptors[:, 8:].abs().sum() > 0


# ---------------------------------------------------------------------------
# the runner, the streams and the map pickles
# ---------------------------------------------------------------------------

def _sim_source():
    from roman_tpu_torch.sim.observations import sim_observation_source

    spec = {"seed": 3, "n_robots": 2, "n_objects": 50, "area": [40.0, 40.0, 4.0],
            "traj_len": 8.0, "desc_dim": 16}
    return spec, sim_observation_source(spec, ["robot0", "robot1"], "robot0")


def test_sim_observation_source_is_demo_mappings():
    from demo.mapping import _sim_observation_source
    from roman_tpu.params.data_params import DataParams

    spec, (src, pd, gt, robot) = _sim_source()
    dp = DataParams(runs=["robot0", "robot1"], img_data_params=spec)
    jsrc, jpd, jgt, _ = _sim_observation_source(dp, "robot0", None)
    np.testing.assert_array_equal(pd.poses, jpd.poses)
    np.testing.assert_array_equal(gt.poses, jgt.poses)
    for t in pd.times[::10]:
        pose, obs, fd = src(float(t))
        jpose, jobs, jfd = jsrc(float(t))
        np.testing.assert_array_equal(pose, jpose)
        np.testing.assert_array_equal(fd, jfd)
        assert len(obs) == len(jobs)
        for a, b in zip(obs, jobs):
            np.testing.assert_array_equal(a.point_cloud, b.point_cloud)
            np.testing.assert_array_equal(a.semantic_descriptor, b.semantic_descriptor)


def test_mapping_bench_stream_is_bench_pys(monkeypatch):
    """bench.run_mapping_bench's arrays, caught at the mapper's door."""
    import bench
    from roman_tpu.map import batch_mapper

    caught = []

    class Catch:
        def __init__(self, *args, **kwargs):
            pass

        def update_batch(self, *arrays):
            caught.append(arrays)
            raise StopIteration

    monkeypatch.setattr(batch_mapper, "BatchMapper", Catch)
    with pytest.raises(StopIteration):
        bench.run_mapping_bench(n_frames=8, batch=8, obs_per_frame=6, pts_per_obs=16,
                                desc_dim=8, seed=1)
    ours = mapping_bench_stream(n_frames=8, obs_per_frame=6, pts_per_obs=16, desc_dim=8,
                                seed=1)
    for a, b in zip(caught[0], ours):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_map_runner_runs_observations(backend, tmp_path):
    """run_observations on the port's sim stream: the host backend gives
    roman_tpu's MapRunner's map; the device backend tracks the same
    objects (a counterpart within 1 m for 80% of the host's segments, the
    bar of tests/test_batch_mapper.py); roman_tpu reads either pickle."""
    from roman_tpu.data.pose_data import PoseData as JPoseData
    from roman_tpu.map.run import MapRunner as JMapRunner
    from roman_tpu.params.fastsam_params import FastSAMParams as JFast

    _, (_, pd, _, _) = _sim_source()
    kw = dict(min_2d_iou=None, min_sightings=2, max_t_no_sightings=0.5,
              geometric_score_range=(0.15, 1.0), min_max_extent=0.05,
              max_segments=32, max_points_per_segment=64)
    fp = dict(batch_frames=6, max_masks_per_frame=16)
    maps = {}
    for b in dict.fromkeys(("host", backend)):
        runner = MapRunner(MapperParams(mapper_backend=b, **kw), FastSAMParams(**fp),
                           CameraParams.simple(), pd, dt=1 / 6, device="cpu")
        maps[b] = runner.run_observations(src_copy())
        assert len(runner.times.map_times) == len(runner.frame_times())
    m = maps[backend]
    assert len(m.segments) >= 5 and len(m.times) == len(runner.frame_times())
    if backend == "host":
        jr = JMapRunner(JParams(mapper_backend="host", **kw), JFast(**fp), JCam.simple(),
                        JPoseData.from_times_and_poses(pd.times, pd.poses), dt=1 / 6)
        _assert_maps_equal(m, jr.run_observations(src_copy()))
    else:
        hc = np.stack([s.center for s in maps["host"].segments])
        dc = np.stack([s.center for s in m.segments])
        d = np.linalg.norm(hc[:, None] - dc[None], axis=-1)
        assert (d.min(axis=1) < 1.0).mean() >= 0.8
    path = str(tmp_path / "m.pkl")
    m.save(path)
    _assert_maps_equal(jrm.load_roman_map(path), m)


def src_copy():
    """A fresh stream with the same seed (the source draws its noise as it
    goes)."""
    return _sim_source()[1][0]


def test_map_runner_run_needs_a_frontend():
    """run() with no front end passed builds the port's PerceptionFrontend
    on the runner's device and maps the frames through it."""
    from roman_tpu_torch.perception.wrapper import PerceptionFrontend

    _, (_, pd, _, _) = _sim_source()
    fs = FastSAMParams(seg_arch="tiny", vit_arch="tiny", imgsz=(32, 32), batch_frames=2,
                       max_masks_per_frame=4, max_points_per_mask=16)
    runner = MapRunner(MapperParams(), fs, CameraParams.simple(width=32, height=32, f=30.0),
                       pd, tf=pd.t0 + 0.5, dt=0.25, device="cpu")
    runner.run(lambda ts: (np.zeros((len(ts), 32, 32, 3), np.uint8),
                           np.full((len(ts), 32, 32), 2.0, np.float32)))
    assert isinstance(runner.frontend, PerceptionFrontend)
    assert runner.frontend.device.type == "cpu"
    assert len(runner.times.total_times) == 2


def test_map_runner_run_with_an_injected_frontend():
    """run() with a front end passed in, on both backends."""
    import types

    _, (_, pd, _, _) = _sim_source()

    class Frontend:
        def run_batch(self, images, depths):
            B = len(images)
            pts = np.zeros((B, 4, 16, 3), np.float32)
            rng = np.random.default_rng(len(images))
            pts[:, :2] = np.array([0.0, 0.0, 4.0]) + rng.normal(size=(B, 2, 16, 3)) * 0.1
            valid = np.zeros((B, 4), bool)
            valid[:, :2] = True
            return types.SimpleNamespace(
                points=pts, points_valid=np.ones((B, 4, 16), bool), valid=valid,
                embeddings=np.ones((B, 4, 8), np.float32),
                frame_descriptors=[np.ones(8)] * B)

        def observations(self, out, ts, poses):
            return [[Observation(time=float(t), pose=p, point_cloud=out.points[b, k],
                                 semantic_descriptor=out.embeddings[b, k])
                     for k in range(4) if out.valid[b, k]]
                    for b, (t, p) in enumerate(zip(ts, poses))]

    for backend in ("host", "device"):
        runner = MapRunner(MapperParams(mapper_backend=backend, min_2d_iou=None,
                                        max_segments=16, max_points_per_segment=32),
                           FastSAMParams(batch_frames=4, max_masks_per_frame=4),
                           CameraParams.simple(), pd, frontend=Frontend(), device="cpu",
                           tf=pd.t0 + 2.0)
        m = runner.run(lambda ts: (np.zeros((len(ts), 4, 4, 3)), np.zeros((len(ts), 4, 4))))
        assert len(m.times) == len(runner.frame_times()) and len(m.segments) >= 1
