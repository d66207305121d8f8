"""Stand-alone loop closures: submap alignment of two map pickles (port of
demo/loop_closures.py; reference demo/loop_closures.py).

    python -m roman_tpu_torch.demo.loop_closures MAP1.pkl MAP2.pkl -o OUT \\
        [-p submap_align.yaml] [-g GT1.yaml GT2.yaml] [-n 4] [--cpu]

It runs ``submap_align`` on the two maps, which launches the four kernels
of the fused path on ``cuda``, writes the alignment artifacts under
OUT/<run-name>.* and prints how many loop closures it wrote. Without
--cpu it runs on the card and raises on a host without one before it
writes anything; --cpu runs the plain PyTorch path on the CPU. It
registers pairs at submap_align's default chunk, as the demo's align
stage does, so on the card the two write the same bytes (the solve's
sums depend on the chunk through ``clipper_solve.cluster_size``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from roman_tpu_torch.align.results import SubmapAlignResults
from roman_tpu_torch.align.submap_align import submap_align
from roman_tpu_torch.params.submap_align_params import (
    SubmapAlignInputOutput,
    SubmapAlignParams,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m roman_tpu_torch.demo.loop_closures")
    parser.add_argument("inputs", nargs=2, help="two ROMAN map .pkl files")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-p", "--params", default=None,
                        help="submap_align.yaml path")
    parser.add_argument("-g", "--gt", nargs=2, default=[None, None],
                        help="gt pose yaml per robot")
    parser.add_argument("-n", "--num-req-assoc", type=int, default=4)
    parser.add_argument("--run-name", default="align")
    parser.add_argument("--skip-distance", type=float, default=np.inf)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> SubmapAlignResults:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to align "
                           "on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    sm_params = (SubmapAlignParams.from_yaml(args.params)
                 if args.params else SubmapAlignParams())
    names = [os.path.splitext(os.path.basename(p))[0] for p in args.inputs]
    sm_io = SubmapAlignInputOutput(
        inputs=args.inputs,
        output_dir=args.output_dir,
        run_name=args.run_name,
        input_gt_pose_yaml=list(args.gt),
        robot_names=names,
        lc_association_thresh=args.num_req_assoc,
        skip_distance=args.skip_distance,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    results = submap_align(sm_params, sm_io, device=device)
    n_lc = int((np.nan_to_num(results.clipper_num_associations)
                >= args.num_req_assoc).sum())
    print(f"{n_lc} loop closures written to {sm_io.output_g2o}")
    return results


if __name__ == "__main__":
    main()
