"""Faults planted in the port's timed path, each a way the program could go
wrong that a cell's comparison has to catch: the benchmark's tests plant
them on the CPU, and calibrate.py --fault reads them on the card at a
cell's own size.

    with faults.planted("keep_half"):
        ...   # the program, as it is built and run inside the block

FAULTS maps each name to the number of the comparison it has to fail.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = {
    "state_unchanged": "map_mismatch",     # a mapper step returns its state
    "half_the_batch": "fdesc_gap",         # half a batch's frame descriptors, the rest their mean
    "shifted_points": "point_gap",         # lifted points 1 cm off
    "keep_half": "keep_mismatch",          # half a batch's frames keep no proposal
    "masks_emptied": "mask_mismatch",      # half a batch's frames' masks left empty
}


def _second_half(n: int, device) -> torch.Tensor:
    """(n,) bool: the frames of the batch's second half."""
    return torch.arange(n, device=device) >= max(n // 2, 1)


def _patches(name: str):
    from roman_tpu_torch.map import batch_mapper
    from roman_tpu_torch.perception import fastsam, wrapper

    if name == "state_unchanged":
        def step(self, state, *args):
            return state
        return [(batch_mapper.BatchMapper, "_step", step)]
    if name == "half_the_batch":
        frame_descriptor = wrapper.frame_descriptor

        def broken_fd(patches, kind="dino-gem", gem_p=3.0):
            d = frame_descriptor(patches, kind, gem_p)
            h = max(len(d) // 2, 1)
            return torch.cat([d[:h], d[:h].mean(0, keepdim=True).expand(len(d) - h, -1)])
        return [(wrapper, "frame_descriptor", broken_fd)]
    if name == "shifted_points":
        lift = wrapper.PerceptionFrontend.lift

        def broken_lift(self, masks, depths):
            pts, valid = lift(self, masks, depths)
            return pts + torch.tensor([0.01, 0.0, 0.0], device=pts.device), valid
        return [(wrapper.PerceptionFrontend, "lift", broken_lift)]
    if name == "keep_half":
        select = fastsam.select_proposals

        def broken_select(*args, **kwargs):
            idx, boxes, scores, coeffs, keep = select(*args, **kwargs)
            keep = keep & ~_second_half(len(keep), keep.device)[:, None]
            return idx, boxes, scores, coeffs, keep
        return [(fastsam, "select_proposals", broken_select)]
    if name == "masks_emptied":
        assemble = fastsam.assemble_masks

        def broken_assemble(proto, mask_coeffs, boxes, out_hw):
            m = assemble(proto, mask_coeffs, boxes, out_hw)
            return m & ~_second_half(len(m), m.device)[:, None, None, None]
        return [(fastsam, "assemble_masks", broken_assemble)]
    raise KeyError(f"no fault {name!r} (there are {sorted(FAULTS)})")


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in the program for the block."""
    with contextlib.ExitStack() as stack:
        for target, attr, value in _patches(name):
            stack.enter_context(mock.patch.object(target, attr, value))
        yield
