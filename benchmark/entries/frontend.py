"""Traffic entry `frontend`: the demo's mapping stage for one robot. Each
operation is one `MapRunner.run` of the port over the drive's next
frames_per_op RGB-D frames: the port's PerceptionFrontend (FastSAM-x and
DINOv2-base in one program a batch, mask filters and lifting) and its
device BatchMapper, as a robot keeps one mapping session. The map carries
on from operation to operation, and each run returns it home.

Set-up renders the drive on the device (benchmark/drive.py), draws both
nets' weights on the device in their upstream layouts
(frontend_f32.draw_weights, the segmentation heads' last biases set on the
drive's first batch), hands them to the port through its own
loaders for those layouts, and runs warmup_ops operations, which capture
the port's CUDA graphs. The drive and the weights (the scene) come from the
configuration's scene seed, so every run does the same work; the run's
seed sets the frame the run starts at on the loop, and the sampled
batches.

The cell wraps calls of the front end and the mapper, as a robot's
mapping session makes them, in the program's spans
(roman_tpu_torch.tracing, on only while the profiler records):
perception.upload (inputs), perception.program (program) and
perception.home (run_batch, whose self time, what the other two leave, is
the copies of the fields home), mapper.update (update_batch) and
mapper.export (get_roman_map). It keeps, for the check, a reference to
each batch's PerceptionOutput, the anchor of each proposal (program) and
the program's own keep of them (the `ok` that mask_filters is given);
and for one batch, drawn from the seed, of every sample_every_ops-th
operation from the first, the frame-size masks (lift) and the mapper's
state before the batch and after its frames (at maybe_spill), for the
filters', lifting's, pooling's and the mapper's step-by-step check. Those
two states are the only copies it makes in the window (snapshot_s says
what they cost).

On the CPU (a rehearsal in the tests) the configuration's `rehearsal`
sizes replace the published ones.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark import drive
from benchmark.reference import frontend_f32 as ref
from benchmark.reference import mapper_step


class Cell:
    unit = "frames"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from roman_tpu_torch.data.camera import CameraParams
        from roman_tpu_torch.map.run import MapRunner
        from roman_tpu_torch.params.fastsam_params import FastSAMParams
        from roman_tpu_torch.params.mapper_params import MapperParams
        from roman_tpu_torch.perception import dinov2, fastsam, wrapper

        self.device = torch.device(device)
        fs, mp, cam = dict(config["fastsam"]), dict(config["mapper"]), dict(config["camera"])
        self.frames_per_op = traffic["frames_per_op"]
        seg_cfg = None
        if self.device.type != "cuda":
            rh = config["rehearsal"]
            fs.update({k: rh[k] for k in ("seg_arch", "vit_arch", "imgsz", "batch_frames",
                                          "max_masks_per_frame", "max_points_per_mask",
                                          "min_mask_len_div", "max_mask_len_div")})
            mp.update(max_segments=rh["max_segments"],
                      max_points_per_segment=rh["max_points_per_segment"])
            cam, self.frames_per_op = dict(rh["camera"]), rh["frames_per_op"]
            # the rehearsal's program runs in float32, as its reference
            seg_cfg = dataclasses.replace(wrapper.SEG_ARCHS[fs["seg_arch"]], dtype=torch.float32)
        self.fparams, self.mparams = FastSAMParams(**fs), MapperParams(**mp)
        K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])
        self.camera = CameraParams(K=K, width=cam["width"], height=cam["height"])
        self.seg_arch, self.vit_arch = ref.SEG_ARCHS[fs["seg_arch"]], ref.VIT_ARCHS[fs["vit_arch"]]
        self.batch = self.fparams.batch_frames
        self.dt = traffic["dt"]
        marks = [time.perf_counter()]
        # the scene (the drive and the nets' weights) is the configuration's;
        # the run's seed picks where on the loop the run starts and which
        # batches are sampled
        self.scene_seed = config["scene"]["seed"]
        self.drive = drive.render(config["scene"], cam, traffic["loop_frames"], self.dt,
                                  self.scene_seed, self.device)
        marks.append(time.perf_counter())
        seg_w, vit_w = ref.draw_weights(self.scene_seed, self.seg_arch, self.vit_arch,
                                        self.device, self.calib())
        seg_sd = fastsam.convert_ultralytics_state_dict(seg_w)
        vit_sd = dinov2.convert_torch_state_dict(vit_w, wrapper.VIT_ARCHS[fs["vit_arch"]])
        del seg_w, vit_w
        marks.append(time.perf_counter())
        self.fe = wrapper.PerceptionFrontend(self.fparams, self.camera, seg_cfg=seg_cfg,
                                             seg_weights=seg_sd, vit_weights=vit_sd,
                                             device=self.device)
        del seg_sd, vit_sd
        self.runner = MapRunner(self.mparams, self.fparams, self.camera,
                                drive.LoopPoses(self.drive, 0.0, 0.0), frontend=self.fe,
                                t0=0.0, tf=0.0, dt=self.dt, device=self.device)
        # one batch, from the seed, of every sample_every_ops-th operation
        # has its frame-size masks and the mapper's states kept for the check
        self.rng = np.random.default_rng([int(seed) % (2**63), 0x5A3])
        self.next_frame = int(self.rng.integers(len(self.drive) // self.batch)) * self.batch
        self.sample_every = traffic["sample_every_ops"]
        self.batch_k, self.sampled = 0, None
        self.rec, self.frames, self.anchors, self.keep, self.masks = None, None, None, None, None
        self.traced_frames = self.traced_masks = 0
        self.segments = self.spills = 0
        self.snapshot_s = 0.0
        self.records = []
        self._wrap_frontend()
        marks.append(time.perf_counter())
        for _ in range(traffic["warmup_ops"]):
            self._run()
        self._wrap_mapper()
        marks.append(time.perf_counter())
        print("set-up of the cell: " + ", ".join(
            f"{what} {b - a:.3f} s" for what, a, b in zip(
                ("drive", "weights", "nets and runner", "warm-up"), marks, marks[1:])),
              file=sys.stderr, flush=True)

    def calib(self) -> torch.Tensor:
        """The frames the segmentation heads' biases are set on: the
        drive's first batch at the net's input size."""
        hw = [max(32, (int(x) // 32) * 32) for x in self.fparams.imgsz]
        return ref.calib_frames(self.drive.images[:self.batch], hw, self.device)

    # -- the wrapped calls ------------------------------------------------
    def _wrap_frontend(self):
        from roman_tpu_torch import tracing

        fe = self.fe
        run_batch, inputs, program = fe.run_batch, fe.inputs, fe.program
        mask_filters, lift = fe.mask_filters, fe.lift

        def run_batch_w(images, depths):
            with tracing.span("perception.home"):
                out = run_batch(images, depths)
            if self.rec is not None:
                self.rec.append(dict(frames=self.frames, out=out, anchors=self.anchors,
                                     keep=self.keep, masks=self.masks))
            if tracing.recording():
                self.traced_frames += len(out.valid)
                self.traced_masks += int(out.valid.sum())
            self.masks = None
            return out

        def inputs_w(images, depths):
            with tracing.span("perception.upload"):
                return inputs(images, depths)

        def program_w(images, depths, graph=True):
            with tracing.span("perception.program"):
                out = program(images, depths, graph)
            self.anchors = out["anchors"]
            return out

        def mask_filters_w(masks, ok):
            self.keep = ok
            return mask_filters(masks, ok)

        def lift_w(masks, depths):
            if self.batch_k == self.sampled:
                self.masks = masks
            return lift(masks, depths)

        fe.run_batch, fe.inputs, fe.program = run_batch_w, inputs_w, program_w
        fe.mask_filters, fe.lift = mask_filters_w, lift_w

    def _wrap_mapper(self):
        from roman_tpu_torch import tracing

        mapper = self.runner.mapper
        update, export, spill = mapper.update_batch, mapper.get_roman_map, mapper.maybe_spill

        def snapshot():
            t0 = time.perf_counter()
            st = mapper.state
            out = {k: getattr(st, k).clone() for k in mapper_step.FIELDS}
            self.snapshot_s += time.perf_counter() - t0
            return out

        def update_w(times, poses, points, points_valid, descriptors, obs_mask,
                     frame_descriptors=None):
            if self.rec and self.rec[-1]["masks"] is not None:
                self.rec[-1]["map"] = dict(before=snapshot(), spills=self.spills, inputs=(
                    times, poses, points, points_valid, descriptors, obs_mask))
            with tracing.span("mapper.update"):
                return update(times, poses, points, points_valid, descriptors, obs_mask,
                              frame_descriptors=frame_descriptors)

        def spill_w(force=False):
            if self.rec and "map" in self.rec[-1] and "after" not in self.rec[-1]["map"]:
                self.rec[-1]["map"]["after"] = snapshot()
            st = mapper.state
            spill(force)
            self.spills += mapper.state is not st

        def export_w():
            with tracing.span("mapper.export"):
                return export()

        mapper.update_batch, mapper.get_roman_map = update_w, export_w
        mapper.maybe_spill = spill_w

    def _frames(self, ts):
        idx = self.drive.frame(ts)
        self.frames = idx
        self.batch_k = int((idx[0] - self.op_first) % len(self.drive)) // self.batch
        i0 = int(idx[0])
        if np.array_equal(idx, np.arange(i0, i0 + len(idx))):
            return self.drive.images[i0:i0 + len(idx)], self.drive.depths[i0:i0 + len(idx)]
        return self.drive.images[idx], self.drive.depths[idx]

    def _run(self):
        self.op_first = self.next_frame % len(self.drive)
        self.runner.t0 = self.next_frame * self.dt
        self.runner.tf = (self.next_frame + self.frames_per_op) * self.dt - self.dt / 2
        m = self.runner.run(self._frames)
        self.next_frame += self.frames_per_op
        self.segments = len(m.segments)
        return m

    # -- the harness's interface -------------------------------------------
    def op(self, k: int):
        """One MapRunner.run over the next frames; returns (the batches'
        records, frames mapped)."""
        per_op = self.frames_per_op // self.batch
        self.sampled = (int(self.rng.integers(per_op))
                        if k % self.sample_every == 0 else None)
        self.rec = []
        self._run()
        rec, self.rec, self.sampled = self.rec, None, None
        return rec, self.frames_per_op

    def describe(self) -> str:
        traced = (f", {self.masks_per_frame():.2f} valid masks a traced frame"
                  if self.traced_frames else "")
        return (f"{self.frames_per_op} frames an operation in batches of {self.batch}, "
                f"{self.segments} segments in the last map, {self.spills} spills since "
                f"set-up began, the check's pool copies {1e3 * self.snapshot_s:.3f} ms{traced}")

    def masks_per_frame(self):
        return self.traced_masks / self.traced_frames if self.traced_frames else None

    def work(self, n_ops: int):
        """The nets' work in n_ops operations (metrics/_frontend_counts.py)."""
        from benchmark.metrics import _frontend_counts

        w = _frontend_counts.frame_work(self.seg_arch, self.vit_arch, self.fparams,
                                        self.camera.height, self.camera.width)
        return {k: v * self.frames_per_op * n_ops for k, v in w.items()}

    def release(self):
        del self.runner, self.fe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, outputs: list) -> dict:
        from benchmark.reference import frontend_compare

        self.records = [r for rec in outputs for r in rec]
        t0 = time.perf_counter()
        nums = frontend_compare.numbers(self, self.records)
        print(f"reference: {len(self.records)} batches in {time.perf_counter() - t0:.3f} s; "
              + ", ".join(f"{k} {nums[k]}" for k in frontend_compare.RECORD),
              file=sys.stderr, flush=True)
        return nums

    def control(self) -> dict:
        """The control's numbers on the frames and anchors of the last
        check."""
        from benchmark.reference import frontend_compare

        return frontend_compare.numbers(self, self.records, control=True)
