"""A saved map pickle as a 3D figure (port of demo/map_viz.py; reference
demo/o3d_viz.py, drawn with matplotlib instead of open3d).

    python -m roman_tpu_torch.demo.map_viz MAP.pkl [-o OUT.png]
        [--show-text] [--no-orig] [-t T0 T1]

Writes OUT.png (default: the pickle's path with .png). Host code only;
needs matplotlib, and without it raises an ImportError naming it before
it writes anything.
"""

from __future__ import annotations

import argparse

from roman_tpu_torch.map.roman_map import load_roman_map
from roman_tpu_torch.viz import pyplot, plot_map_3d


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(prog="python -m roman_tpu_torch.demo.map_viz")
    parser.add_argument("map_pkl")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--show-text", action="store_true",
                        help="display segment id labels (o3d_viz.py flag)")
    parser.add_argument("--no-orig", action="store_true",
                        help="do not display the origin frame")
    parser.add_argument("-t", "--time-range", type=float, nargs=2,
                        help="only segments seen within [t0, t1]")
    args = parser.parse_args(argv)
    plt = pyplot("map_viz")

    m = load_roman_map(args.map_pkl)
    plot_map_3d(m.segments, trajectory=m.trajectory,
                time_range=args.time_range,
                show_labels=args.show_text,
                show_origin=not args.no_orig)
    out = args.output or args.map_pkl.replace(".pkl", ".png")
    plt.savefig(out, dpi=150)
    print(f"saved {out} ({len(m.segments)} segments)")
    return out


if __name__ == "__main__":
    main()
