"""Association figures, or the camera-frame association video, for the
accepted loop closures of one alignment (port of demo/association_vid.py;
reference demo/association_vid.py:63-317).

    python -m roman_tpu_torch.demo.association_vid ALIGN.pkl -o OUT
        [-n 4] [--aligned] [--video [--fps 2]]
        [--camera-video [--idx I J] [--images IMGS0 IMGS1] [--camera-fps 6]]

- default: one 3D association figure a loop-closure pair,
  OUT/assoc_III_JJJ.png (``align_viz.align_viz``), and with --video the
  figures composed into OUT/associations.mp4;
- --camera-video: the reference's camera-frame video for one submap pair
  (--idx, or the pair with the most associations), OUT/association_camera.mp4:
  side-by-side camera frames over the synchronized time window, each
  match's outline reprojected from its segments' points, green lines
  between the nearest outline pixels (``align_viz.association_camera_video``).
  --images gives each robot's recording (an npz file or an image
  directory); sim worlds have none, and a two-tone canvas stands in.

Host code only. The figures need matplotlib and the videos OpenCV; a
missing one raises an ImportError naming it before anything is written.
"""

from __future__ import annotations

import argparse
import os

from roman_tpu_torch.align import align_viz
from roman_tpu_torch.align.results import SubmapAlignResults
from roman_tpu_torch.map.roman_map import (SubmapParams, load_roman_map,
                                           submaps_from_roman_map)
from roman_tpu_torch.utils import require
from roman_tpu_torch.viz import pyplot, write_video


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m roman_tpu_torch.demo.association_vid")
    parser.add_argument("results_pkl", help="align .pkl results file")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-n", "--num-req-assoc", type=int, default=4)
    parser.add_argument("--aligned", action="store_true",
                        help="apply the estimated T (overlapping view)")
    parser.add_argument("--video", action="store_true",
                        help="also compose the figures into a video")
    parser.add_argument("--fps", type=float, default=2.0)
    parser.add_argument("--camera-video", action="store_true",
                        help="render the camera-frame association video "
                             "for one submap pair (reference "
                             "association_vid.py capability)")
    parser.add_argument("--idx", type=int, nargs=2, default=None,
                        help="submap pair for --camera-video (default: "
                             "max associations)")
    parser.add_argument("--images", type=str, nargs=2, default=None,
                        metavar=("IMGS0", "IMGS1"),
                        help="per-robot image recordings (npz file or "
                             "image dir) for --camera-video")
    parser.add_argument("--camera-fps", type=float, default=6.0)
    return parser.parse_args(argv)


def main(argv=None) -> list:
    """Returns the paths written."""
    args = parse_args(argv)
    if args.camera_video or args.video:
        require("cv2", "association_vid")
    if not args.camera_video:
        pyplot("association_vid")

    results = SubmapAlignResults.load(args.results_pkl)
    maps = [load_roman_map(p) for p in results.submap_io.inputs]
    sp = SubmapParams.from_submap_align_params(results.submap_align_params)
    submaps = [submaps_from_roman_map(m, sp) for m in maps]

    if args.camera_video:
        img_data = None
        if args.images is not None:
            from roman_tpu_torch.data.img_data import ImgData

            img_data = [
                ImgData.from_npz(p) if p.endswith(".npz")
                else ImgData.from_dir(p)
                for p in args.images
            ]
        os.makedirs(args.output_dir, exist_ok=True)
        out, n = align_viz.association_camera_video(
            results, submaps, maps,
            os.path.join(args.output_dir, "association_camera.mp4"),
            idx=args.idx, fps=args.camera_fps, img_data=img_data)
        print(f"wrote {n}-frame camera association video to {out}")
        return [out]

    written = align_viz.align_viz(submaps[0], submaps[1], results, args.output_dir,
                                  num_req_assoc=args.num_req_assoc,
                                  aligned=args.aligned)
    print(f"wrote {len(written)} association figures to {args.output_dir}")
    if args.video and written:
        cv = require("cv2", "association_vid")
        frames = [cv.cvtColor(cv.imread(p), cv.COLOR_BGR2RGB) for p in written]
        out = write_video(frames, os.path.join(args.output_dir, "associations.mp4"),
                          fps=args.fps)
        print(f"wrote association video to {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
