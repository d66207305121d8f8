"""The reference's demo/o3d_viz.py name for ``map_viz`` (port of
demo/o3d_viz.py): ``python -m roman_tpu_torch.demo.o3d_viz MAP.pkl
[--show-text] [--no-orig] [-t T0 T1]`` takes map_viz's flags and writes
what it writes."""

from roman_tpu_torch.demo.map_viz import main

if __name__ == "__main__":
    main()
