"""Traffic entry `frontend_clip`: the `frontend` entry's mapping session
with the configuration's `semantics: clip`. The port's PerceptionFrontend
then embeds every proposal's box crop with CLIP ViT-L/14 (its stage
`clip_stage`, a CUDA graph of its own, after the filters) in place of
DINOv2's mask pooling; DINOv2 still gives the frame descriptors.

Set-up draws CLIP's weights on the device in transformers'
CLIPVisionModelWithProjection layout from the scene's seed
(clip_f32.draw_weights, a stream of its own, so FastSAM-x's and DINOv2's
are the `frontend` cell's bit for bit) and hands them to the port through
its loader (clip.convert_torch_state_dict) before the warm-up captures
anything; the rest is the `frontend` entry's.

The check is the `frontend` cell's, but for emb_gap: the largest
1 - cosine between the program's CLIP embedding of a slot and the
reference's (clip_f32, float32: the box, the stretched crop and the tower
on the program's own frame-size masks), over the sampled batches' slots
that the program keeps and the reference's filters keep. The control's
emb_gap is the reference at the control's precision on the same crops and
slots.

On the CPU (a rehearsal in the tests) the configuration's `rehearsal`
sizes replace the published ones, CLIP's among them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from unittest import mock

import torch

from benchmark.entries import frontend
from benchmark.reference import clip_f32
from benchmark.reference import frontend_f32 as ref


class Cell(frontend.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from roman_tpu_torch.perception import clip, wrapper

        on_card = torch.device(device).type == "cuda"
        name = config["nets"]["clip_arch"] if on_card else config["rehearsal"]["clip_arch"]
        self.clip_arch = a = clip_f32.ARCHS[name]
        cfg = dataclasses.replace(clip.CLIP_VIT_L14, width=a.width, depth=a.depth, heads=a.heads,
                                  patch=a.patch, img_size=a.img_size, proj_dim=a.proj_dim,
                                  mlp_ratio=a.mlp / a.width, ln_eps=a.ln_eps)
        if on_card and cfg != clip.CLIP_VIT_L14:
            raise ValueError(f"{name} is not the port's CLIP_VIT_L14: {cfg}")
        if not on_card:  # the rehearsal's program runs in float32, as its reference
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
        t0 = time.perf_counter()
        sd = clip.convert_torch_state_dict(
            clip_f32.draw_weights(config["scene"]["seed"], a, device), cfg)
        print(f"set-up of the cell: CLIP weights {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)
        make = wrapper.PerceptionFrontend

        def with_clip(*args, **kwargs):
            return make(*args, clip_cfg=cfg, clip_weights=sd, **kwargs)

        with mock.patch.object(wrapper, "PerceptionFrontend", with_clip):
            super().__init__(config, traffic, seed, device)
        self.compared, self.clip_w = [], None  # of the last check (_compared)

    def clip_work(self) -> dict:
        """The CLIP stage's work in the traced stretch, by the crops the
        program kept there (metrics/_clip_counts.py)."""
        from benchmark.metrics import _clip_counts

        return _clip_counts.crops_work(self.clip_arch, self.traced_masks,
                                       self.traced_frames // self.batch)

    def work(self, n_ops: int):
        w, c = super().work(n_ops), self.clip_work()
        return {k: w[k] + c[k] for k in w}

    # -- the comparison ---------------------------------------------------
    def check(self, outputs: list) -> dict:
        kept = []
        with _reference_keep(kept):
            nums = super().check(outputs)
        self.compared = self._compared(kept)
        return self._with_clip_gap(nums, None)

    def control(self) -> dict:
        return self._with_clip_gap(super().control(), ref.CONTROL)

    def _compared(self, kept: list) -> list:
        """[(frames (B, 3, H, W), frame-size masks, (frame, slot) index
        arrays, the float32 reference's embeddings there, the program's)]
        of the last check's sampled batches: the slots the program keeps
        and the reference's filters keep (`kept`, one a sampled batch)."""
        sampled = [r for r in self.records if r["masks"] is not None]
        if len(sampled) != len(kept):
            raise RuntimeError(f"{len(kept)} keeps of the reference for {len(sampled)} "
                               "sampled batches")
        self.clip_w = clip_f32.draw_weights(self.scene_seed, self.clip_arch, self.device)
        out = []
        with torch.no_grad(), ref.no_tf32():
            for rec, valid_r in zip(sampled, kept):
                both = torch.as_tensor(rec["out"].valid, device=self.device) & valid_r
                slots = tuple(i.cpu().numpy() for i in torch.nonzero(both).T)
                if not len(slots[0]):
                    continue
                img = torch.as_tensor(self.drive.images[rec["frames"]], device=self.device)
                img = img.permute(0, 3, 1, 2).float() / 255.0
                masks = rec["masks"].to(self.device)
                want = clip_f32.embeddings(self.clip_w, self.clip_arch, img, masks, slots)
                got = torch.as_tensor(rec["out"].embeddings, device=self.device)[slots]
                out.append((img, masks, slots, want, got))
        return out

    def _with_clip_gap(self, nums: dict, low) -> dict:
        """nums with emb_gap the largest 1 - cosine over the compared slots
        of the program's CLIP embeddings (or, with low, the reference's at
        that precision) against the float32 reference's."""
        gap, n = 0.0, 0
        with torch.no_grad(), ref.no_tf32():
            for img, masks, slots, want, got in self.compared:
                if low is not None:
                    got = clip_f32.embeddings(self.clip_w, self.clip_arch, img, masks, slots, low)
                got, want = got.double(), want.double()
                cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1)).clamp(
                    min=1e-30)
                gap, n = max(gap, float((1.0 - cos).max())), n + len(cos)
        nums["emb_gap"] = gap
        print(f"reference: CLIP{' (control)' if low is not None else ''} on {n} slots of "
              f"{len(self.compared)} sampled batches, emb_gap {gap}", file=sys.stderr, flush=True)
        return nums


@contextlib.contextmanager
def _reference_keep(into: list):
    """Keeps, in `into`, the valid flags of each float32 run of the
    reference's filters (one a sampled batch) inside the block."""
    from benchmark.reference import frontend_compare

    filters = frontend_compare.Reference.filters

    def keep(self, masks, depth, p: ref.Precision = ref.F32):
        out = filters(self, masks, depth, p)
        if p is ref.F32:
            into.append(out[0])
        return out

    with mock.patch.object(frontend_compare.Reference, "filters", keep):
        yield
