"""Merge time-chunked map pickles into one (port of
demo/merge_demo_output.py; reference demo/merge_demo_output.py, for
maps of ``python -m roman_tpu_torch.demo --max-time``).

    python -m roman_tpu_torch.demo.merge_demo_output CHUNK.pkl ... -o OUT.pkl

``RomanMap.concatenate`` shifts the segment ids of each later chunk past
the running maximum; the merged map is written as roman_tpu names its
classes, so either package reads it. Host code only.
"""

from __future__ import annotations

import argparse

from roman_tpu_torch.map.roman_map import RomanMap


def main(argv=None) -> RomanMap:
    parser = argparse.ArgumentParser(prog="python -m roman_tpu_torch.demo.merge_demo_output")
    parser.add_argument("inputs", nargs="+", help="chunk .pkl files (in order)")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)

    maps = [RomanMap.from_pickle(p) for p in args.inputs]
    merged = RomanMap.concatenate(maps)
    merged.save(args.output)
    print(f"merged {len(maps)} chunks -> {len(merged.segments)} segments "
          f"at {args.output}")
    return merged


if __name__ == "__main__":
    main()
