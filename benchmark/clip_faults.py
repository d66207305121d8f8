"""Faults planted in the CLIP stage of the port's front end, which the
frontend_clip cell's comparison has to catch (its emb_gap): the
benchmark's tests plant them on the CPU, and this script reads them on the
card at the cell's own size, through calibrate.py:

    python3 benchmark/clip_faults.py --workload frontend_clip --seeds 1 2 3 --fault clip_mean

(calibrate.py's arguments; --fault also takes benchmark/faults.py's).

    with clip_faults.planted("clip_boxes_shifted"):
        ...   # the program, as it is built and run inside the block

FAULTS maps each name to the number of the comparison it has to fail.
"""

from __future__ import annotations

import contextlib
import os
import sys
from unittest import mock

import torch

FAULTS = {
    "clip_mean": "emb_gap",            # half a batch's CLIP embeddings, each frame's their mean
    "clip_boxes_shifted": "emb_gap",   # every crop box 4 px right and down
}
SHIFT_PX = 4.0


def _patches(name: str):
    from roman_tpu_torch.perception import wrapper

    if name == "clip_mean":
        embed = wrapper.clip_bbox_embeddings

        def broken_embed(images, boxes, clip_model, out_size=224):
            e = embed(images, boxes, clip_model, out_size)
            half = torch.arange(len(e), device=e.device) >= max(len(e) // 2, 1)
            return torch.where(half[:, None, None], e.mean(1, keepdim=True).expand_as(e), e)
        return [(wrapper, "clip_bbox_embeddings", broken_embed)]
    if name == "clip_boxes_shifted":
        mask_bboxes = wrapper._mask_bboxes

        def broken_boxes(masks):
            return mask_bboxes(masks) + SHIFT_PX
        return [(wrapper, "_mask_bboxes", broken_boxes)]
    raise KeyError(f"no fault {name!r} (there are {sorted(FAULTS)})")


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in the program for the block."""
    with contextlib.ExitStack() as stack:
        for target, attr, value in _patches(name):
            stack.enter_context(mock.patch.object(target, attr, value))
        yield


def main(argv=None) -> int:
    """calibrate.py, with these faults beside benchmark/faults.py's."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import calibrate, faults

    others = faults._patches

    def patches(name):
        return _patches(name) if name in FAULTS else others(name)

    with mock.patch.dict(faults.FAULTS, FAULTS), mock.patch.object(faults, "_patches", patches):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
