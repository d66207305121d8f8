"""The front-end cell's reference and comparison on the CPU, at the nets'
tiny test widths: the reference's nets against the port's float32 path,
the whole comparison (masks, lifting, pooling, descriptors, the mapper's
step, the keep) reading the program as the reference on a rehearsal of the
cell, the control reading above a limit, planted faults failing their
numbers, the work counts against a hand count, and the cell's spans and
their device time in a profiled stretch."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from benchmark import faults, harness
from benchmark import trace as trace_mod
from benchmark.metrics import _frontend_counts as counts
from benchmark.reference import frontend_f32 as ref

LIMITS = harness.load_json(harness.HERE, "limits", "frontend_rgbd.json")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_reference_nets_are_the_ports_float32_nets():
    from roman_tpu_torch.perception import dinov2, fastsam, vit, wrapper

    sa, va = ref.SEG_ARCHS["tiny"], ref.VIT_ARCHS["tiny"]
    calib = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    seg_w, vit_w = ref.draw_weights(2**31 + 17, sa, va, "cpu", calib)
    cfg = dataclasses.replace(fastsam.TINY_TEST, dtype=torch.float32)
    seg = fastsam.YoloSeg(cfg)
    seg.load_state_dict(fastsam.convert_ultralytics_state_dict(seg_w))
    vcfg = wrapper.VIT_ARCHS["tiny"]
    net = vit.ViT(vcfg)
    net.load_state_dict(dinov2.convert_torch_state_dict(vit_w, vcfg))
    img = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 84, 126, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = seg.eval()(img)
        boxes, scores, coefs = fastsam.decode_predictions(out, cfg, (64, 96))
        r = ref.seg_forward(seg_w, sa, img)
        _, patches = net.eval()(x)
        r_patches = ref.vit_forward(vit_w, va, x)
    for a, b in ((boxes, r["box"]), (scores, r["score"]), (coefs, r["coef"]),
                 (out["proto"], r["proto"]), (patches, r_patches)):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max().item())


def test_the_work_counts_are_the_hand_counts():
    a = ref.SegArch(width=0.125, depth=0.33, nm=8)
    # one conv at the input: 3 -> ch(64) = 8 channels, 3x3, stride 2
    first = 2 * 3 * 8 * 9 * (64 // 2) * (64 // 2)
    spec = ref.seg_spec(a)
    assert spec["model.0.conv.weight"] == (8, 3, 3, 3)
    total = counts.seg_ops(a, 64, 64)
    assert total > first
    only_first = {"model.0.conv.weight": (8, 3, 3, 3)}
    orig = ref.seg_spec
    try:
        ref.seg_spec = lambda arch: only_first
        assert counts.seg_ops(a, 64, 64) == first
    finally:
        ref.seg_spec = orig
    v = ref.VitArch(width=64, depth=2, heads=4, img_size=84)
    T, D = 6 * 9 + 1, 64
    layer = 2 * T * D * (3 * D + D + 2 * 4 * D) + 2 * T * T * D
    bf16, f32 = counts.vit_ops(v, 6, 9)
    assert bf16 == 2 * layer + 2 * 54 * 3 * 14 * 14 * D and f32 == 2 * 2 * T * T * D
    # FastSAM-x at 256 x 256 and DINOv2-base at 476 x 630: about 400 GFLOP
    seg_x = counts.seg_ops(ref.SEG_ARCHS["fastsam-x"], 256, 256)
    b16, b32 = counts.vit_ops(ref.VIT_ARCHS["dinov2-base"], 34, 45)
    assert 350e9 < seg_x + b16 + b32 < 450e9


@pytest.fixture(scope="module")
def rehearsal():
    """A CPU rehearsal of the cell (its configuration's rehearsal sizes)
    after two operations, released for the check."""
    from benchmark.entries import frontend

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _, config, traffic = harness.find_cell(bench, "frontend_rgbd")
    cell = frontend.Cell(config, traffic, 3, torch.device("cpu"))
    outs = [cell.op(k)[0] for k in range(2)]
    cell.release()
    return cell, outs


def test_the_program_reads_as_the_reference_on_the_cpu(rehearsal):
    cell, outs = rehearsal
    nums = cell.check(outs)
    assert nums["kept_masks"] > 0 and nums["valid_per_sampled_frame"] > 0
    assert any("map" in r for rec in outs for r in rec)
    for k in LIMITS:
        assert nums[k] <= 1e-5, (k, nums[k])


def test_the_control_reads_above_a_limit(rehearsal):
    cell, outs = rehearsal
    cell.check(outs)
    nums = cell.control()
    assert any(nums[k] > LIMITS[k] for k in LIMITS), nums


def test_the_cells_spans_are_read_from_a_profiled_stretch():
    """An operation of a rehearsal under the profiler: each of the cell's
    spans reads a host time (span_ms), the stretch holds no graph capture
    or module load, and the reader of the valid masks counts them."""
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch import tracing

    from benchmark.entries import frontend

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _, config, traffic = harness.find_cell(bench, "frontend_rgbd")
    cell = frontend.Cell(config, traffic, 5, torch.device("cpu"))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace_mod.SPAN):
            cell.op(0)
    t = trace_mod.read(prof)
    ctx = harness.Context(cell=cell, trace=t)
    names = [m["name"] for m in bench["per_layer"] if "frontend_rgbd" in m.get("workloads", [])]
    spans = [n for n in names if n.startswith("span_ms.")]
    assert len(spans) == 5
    for n in spans:
        assert harness.metric_reader(n).read(ctx, n) > 0, n
    assert trace_mod.launched_in(t, "perception.program")[0] == 1
    assert trace_mod.launched_in(t, "mapper.update")[0] == cell.frames_per_op // cell.batch
    assert trace_mod.setup_calls(t) == 0
    assert harness.metric_reader("masks_per_frame.frontend").read(
        ctx, "masks_per_frame.frontend") > 0
    cell.release()
    tracing.reset()


def test_launched_in_takes_the_device_work_launched_inside_a_span():
    """Device intervals by the host call that launched them: those launched
    inside a span (nested or overlapping spans of one name as one) count
    once, by their union; others, and unmatched ones, do not."""
    t = trace_mod.Trace(
        window_s=1.0, busy_s=1.0, n_ops=1, kernels=0, device_ops=[], idle_gaps=[],
        host=[(0, 100, "a"), (10, 20, "a"), (200, 300, "a"), (100, 200, "b")],
        launched=[(50, 150, 15), (140, 160, 90), (400, 450, 250), (500, 900, 150),
                  (600, 700, None)])
    assert trace_mod.launched_in(t, "a") == (3, (160 - 50 + 450 - 400) / 1e9)
    assert trace_mod.launched_in(t, "b") == (1, 400 / 1e9)
    assert trace_mod.launched_in(t, "c") == (0, 0.0)


def _run(capsys, seconds=0.3):
    """The rest of a run of the cell on the CPU at its rehearsal sizes."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    wl, config, traffic = harness.find_cell(bench, "frontend_rgbd")
    assert harness.run_cell(bench, wl, config, traffic, 3, seconds, False,
                            time.time(), device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, [k for k, v in line["checks"].items() if v["value"] > v["limit"]]


def test_a_sound_run_is_correct(capsys):
    line, failed = _run(capsys)
    assert line["correct"] is True and not failed


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_caught(capsys, fault):
    with faults.planted(fault):
        line, failed = _run(capsys)
    assert line["correct"] is False
    assert faults.FAULTS[fault] in failed, line["checks"]


def test_the_mapper_from_its_start_is_the_reference(rehearsal):
    """The step-by-step check starts from the program's own pool; here the
    start and the batches it skips: the port's device mapper on the CPU
    from an empty pool over every batch of the rehearsal's window, against
    the reference's frames from an empty pool."""
    from roman_tpu_torch.map.batch_mapper import BatchMapper

    from benchmark.reference import mapper_step

    cell, outs = rehearsal
    p = cell.mparams
    records = [r for rec in outs for r in rec]
    D = records[0]["out"].embeddings.shape[-1]
    mapper = BatchMapper(p, cell.camera, desc_dim=D,
                         obs_capacity=cell.fparams.max_masks_per_frame, device="cpu")
    pool = mapper_step.Pool(mapper_step.empty_state(p.max_segments, p.max_points_per_segment, D))
    for r in records:
        out = r["out"]
        val = out.points_valid & out.valid[..., None]
        inputs = (r["frames"] * cell.dt, cell.drive.poses[r["frames"]], out.points, val,
                  out.embeddings, out.valid & val.any(-1))
        mapper.update_batch(*inputs)
        for f in range(len(inputs[0])):
            mapper_step.frame(pool, p, *(x[f] for x in inputs[:3]), inputs[3][f].astype(bool),
                              inputs[4][f], inputs[5][f].astype(bool), lambda x: x)
    after = {k: getattr(mapper.state, k).numpy() for k in mapper_step.FIELDS}
    assert (after["status"] != mapper_step.EMPTY).sum() > 0
    assert mapper_step.compare(pool, after)["map_mismatch"] == 0.0


def _near_tie_cloud():
    """Three collinear points spaced 1:2, as a thin mask's voxel means lie:
    outlier removal's statistics are u, 4u/3 and 5u/3, the largest equal
    to the threshold."""
    return np.array([[1.0, 2.0, 0.5], [1.3, 2.0, 0.5], [1.2, 2.0, 0.5]], np.float32)


def test_outlier_removals_near_tie_is_taken_either_way():
    from benchmark.reference import mapper_step

    knives = mapper_step.Knives()
    keep = mapper_step.outlier_keep(_near_tie_cloud(), knives)
    assert knives.met == 1
    other = mapper_step.outlier_keep(_near_tie_cloud(), mapper_step.Knives({0}))
    assert other[0] != keep[0] and (other[1:] == keep[1:]).all()
    cloud = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    knives = mapper_step.Knives()
    mapper_step.outlier_keep(cloud, knives)
    assert knives.met == 0


def test_the_mapper_check_takes_either_reading_of_a_near_tie_and_no_more():
    """A frame that opens a segment from the near-tie cloud: a state with
    the tie read the other way agrees with the reference, one that left the
    pool as it was does not."""
    from roman_tpu_torch.params.mapper_params import MapperParams

    from benchmark.reference import mapper_step

    p = MapperParams(max_segments=4, max_points_per_segment=8)
    before = mapper_step.empty_state(4, 8, 4)
    pts = np.zeros((1, 2, 4, 3), np.float32)
    val = np.zeros((1, 2, 4), bool)
    pts[0, 0, :3], val[0, 0, :3] = _near_tie_cloud(), True
    desc = np.ones((1, 2, 4), np.float32)
    inputs = (np.array([1.0]), np.eye(4)[None], pts, val, desc, np.array([[True, False]]))
    other = mapper_step.as_state(mapper_step.run_batch(
        before, inputs, p, knives=mapper_step.Knives({0})))
    plain = mapper_step.run_batch(before, inputs, p)
    assert mapper_step.compare(plain, other)["map_mismatch"] == 1.0
    assert mapper_step.closest(before, inputs, p, other) == dict(
        map_mismatch=0.0, map_near_ties=1, map_runs=2)
    assert mapper_step.closest(before, inputs, p, before)["map_mismatch"] == 1.0
