"""The frontend_clip cell on the CPU at its configuration's rehearsal
sizes: a sound run reads `correct`, its CLIP emb_gap at float32's
rounding; the control reads above the emb_gap limit; the CLIP stage's
faults (clip_faults.py) fail emb_gap; the stage's work counts against a
hand count; its span and counters read from a profiled stretch."""

import json
import time

import pytest
import torch

from benchmark import clip_faults, harness
from benchmark import trace as trace_mod
from benchmark.metrics import _clip_counts
from benchmark.reference import clip_f32

LIMITS = harness.load_json(harness.HERE, "limits", "frontend_clip.json")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(seed=3):
    from benchmark.entries import frontend_clip

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _, config, traffic = harness.find_cell(bench, "frontend_clip")
    return frontend_clip.Cell(config, traffic, seed, torch.device("cpu"))


def _run(capsys, seconds=0.3):
    """The rest of a run of the cell on the CPU at its rehearsal sizes."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    wl, config, traffic = harness.find_cell(bench, "frontend_clip")
    assert harness.run_cell(bench, wl, config, traffic, 3, seconds, False,
                            time.time(), device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, [k for k, v in line["checks"].items() if v["value"] > v["limit"]]


def test_a_sound_run_is_correct(capsys):
    line, failed = _run(capsys)
    assert line["correct"] is True and not failed
    assert line["checks"]["emb_gap"]["value"] <= 1e-5


def test_the_control_reads_above_the_emb_gap_limit():
    cell = _cell()
    outs = [cell.op(k)[0] for k in range(2)]
    cell.release()
    nums = cell.check(outs)
    assert nums["emb_gap"] <= 1e-5 and nums["valid_per_sampled_frame"] > 0
    assert cell.control()["emb_gap"] > LIMITS["emb_gap"]


@pytest.mark.parametrize("fault", sorted(clip_faults.FAULTS))
def test_a_broken_clip_stage_is_caught(capsys, fault):
    with clip_faults.planted(fault):
        line, failed = _run(capsys)
    assert line["correct"] is False
    assert clip_faults.FAULTS[fault] in failed, line["checks"]


def test_the_clip_work_is_the_hand_count():
    a = clip_f32.ARCHS["clip-vit-l14"]
    T, D = 257, 1024
    layer = 2 * T * D * (3 * D + D + 2 * 4096) + 2 * T * T * D
    bf16, f32 = _clip_counts.crop_ops(a)
    assert bf16 == 24 * layer + 2 * 256 * 3 * 14 * 14 * D + 2 * D * 768
    assert f32 == 24 * 2 * T * T * D
    # 158.8 bf16 and 3.25 f32 GFLOP a crop, 162 in all
    assert round(bf16 / 1e9, 1) == 158.8 and round(f32 / 1e9, 2) == 3.25
    layer_params = 4 * (D * D + D) + 2 * 4096 * D + 4096 + D + 4 * D
    params = (D * 3 * 14 * 14 + D + T * D + 2 * D) + 24 * layer_params + 2 * D + 768 * D
    assert params == 303_966_208  # 303.2 M in the tower, 0.8 M in the projection
    assert _clip_counts.weight_bytes(a) == 2 * params
    w = _clip_counts.crops_work(a, 10, 2)
    assert w["bf16_ops"] == 10 * bf16 and w["bytes"] == 2 * 2 * params + 10 * 4 * 768


def test_the_clip_span_and_counters_read_from_a_profiled_stretch():
    """An operation of a rehearsal under the profiler: the CLIP stage's
    span reads a host time, its counters the crops encoded and kept, and
    the stage's work its kept crops."""
    from torch.profiler import ProfilerActivity, profile

    from roman_tpu_torch import tracing

    cell = _cell(5)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace_mod.SPAN):
            cell.op(0)
    t = trace_mod.read(prof)
    ctx = harness.Context(cell=cell, trace=t)
    per_op = cell.frames_per_op // cell.batch
    assert trace_mod.launched_in(t, "perception.clip")[0] == per_op
    assert harness.metric_reader("span_ms.perception.clip.clip").read(
        ctx, "span_ms.perception.clip.clip") > 0
    K = cell.fparams.max_masks_per_frame
    assert tracing.counter("perception.clip_crops") == cell.frames_per_op * K
    assert tracing.counter("perception.clip_kept") == cell.traced_masks > 0
    share = harness.metric_reader("kept_crop_share.clip").read(ctx, "kept_crop_share.clip")
    assert share == 100.0 * cell.traced_masks / (cell.frames_per_op * K)
    assert cell.clip_work()["f32_ops"] == cell.traced_masks * _clip_counts.crop_ops(
        cell.clip_arch)[1]
    assert trace_mod.setup_calls(t) == 0
    cell.release()
    tracing.reset()
