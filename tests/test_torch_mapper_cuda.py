"""The port's mapping stage on the card against the same code on the CPU.

Needs a CUDA card; without one every test skips. These tests import
nothing of JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \\
        -m cuda tests/test_torch_mapper_cuda.py

The mapping stage has no hand-written kernel: its ops are torch code, and
the CPU run is their referee. Tolerances:
- voxel keys, sorted unique keys, voxel-IOU counts, SOR and cluster masks,
  auction matches and the downsample's valid slots equal;
- downsampled points within 1e-5 (index_add_ sums a voxel's points in
  another order on the card);
- the BatchMapper on bench traffic: per pool slot the same seg_id, status
  and num_sightings, segment centers within 1e-3 m.
"""

import numpy as np
import pytest
import torch

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.map.batch_mapper import BatchMapper
from roman_tpu_torch.ops import hungarian, pointcloud, voxel
from roman_tpu_torch.params.mapper_params import MapperParams
from roman_tpu_torch.sim.observations import mapping_bench_stream

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_map_ops_on_the_card_match_the_cpu(dev):
    rng = np.random.default_rng(0)
    pts = torch.tensor((rng.normal(size=(16, 300, 3)) * 0.4
                        + np.array([-40.0, 75.0, 1.0])).astype(np.float32))
    mask = torch.tensor(rng.uniform(size=(16, 300)) < 0.9)
    on = (pts.to(dev), mask.to(dev))
    for vs in (0.05, 0.2):
        assert torch.equal(voxel.voxel_keys(*on, vs).cpu(), voxel.voxel_keys(pts, mask, vs))
    k1, n1 = voxel.sorted_unique_keys(pts, mask, 0.2)
    k2, n2 = voxel.sorted_unique_keys(pts[:5] + 0.05, mask[:5], 0.2)
    for method in ("compare", "searchsorted"):
        card = voxel.voxel_iou_cross_keys(k1.to(dev), n1.to(dev), k2.to(dev), n2.to(dev),
                                          method=method)
        assert torch.equal(card.cpu(), voxel.voxel_iou_cross_keys(k1, n1, k2, n2, method=method))
    a, am = voxel.voxel_downsample(*on, 0.05, capacity=64, max_coarsen_levels=2)
    b, bm = voxel.voxel_downsample(pts, mask, 0.05, capacity=64, max_coarsen_levels=2)
    assert torch.equal(am.cpu(), bm)
    assert (a.cpu() - b).abs().max() <= 1e-5
    assert torch.equal(pointcloud.statistical_outlier_mask(*on, 10, 1.0).cpu(),
                       pointcloud.statistical_outlier_mask(pts, mask, 10, 1.0))
    assert torch.equal(pointcloud.largest_cluster_mask(*on, 0.25, adaptive_spacing_factor=1.6).cpu(),
                       pointcloud.largest_cluster_mask(pts, mask, 0.25, adaptive_spacing_factor=1.6))
    ben = torch.tensor(rng.uniform(-0.2, 1.0, (64, 24)).astype(np.float32))
    rm, cm = torch.ones(64, dtype=torch.bool), torch.ones(24, dtype=torch.bool)
    assert torch.equal(hungarian.auction_assignment(ben.to(dev), rm.to(dev), cm.to(dev), 64).cpu(),
                       hungarian.auction_assignment(ben, rm, cm, 64))


def test_batch_mapper_on_the_card_matches_the_cpu(dev):
    """bench.py's mapping stream (48 frames of 24 observations of 128
    points, batches of 16) at the full pool size (256 segments of 256
    points)."""
    times, poses, pts, val, desc, mask = mapping_bench_stream(n_frames=48)
    params = MapperParams(min_sightings=2, max_t_no_sightings=2.0,
                          geometric_score_range=(0.1, 1.0))
    maps = [BatchMapper(params, CameraParams.simple(), desc_dim=64, obs_capacity=24,
                        device=d) for d in (dev, "cpu")]
    for m in maps:
        for s in range(0, len(times), 16):
            e = s + 16
            m.update_batch(times[s:e], poses[s:e], pts[s:e], val[s:e], desc[s:e], mask[s:e])
    card, cpu = (m.state for m in maps)
    for name in ("seg_id", "status", "num_sightings"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    assert int(cpu.next_id) > 20
    live = cpu.status.numpy() > 0

    def centers(st):
        p = st.points.cpu().numpy()
        v = st.points_valid.cpu().numpy()
        return np.stack([p[i][v[i]].mean(0) for i in np.flatnonzero(live)])

    assert np.abs(centers(card) - centers(cpu)).max() <= 1e-3
    a, b = (m.get_roman_map() for m in maps)
    assert [s.id for s in a.segments] == [s.id for s in b.segments]
    assert max(np.abs(x.center - y.center).max() for x, y in zip(a.segments, b.segments)) <= 1e-3
