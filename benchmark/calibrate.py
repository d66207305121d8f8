"""The readings the comparison's limits are set from, on the card, at the
cells' own sizes: for each seed, the program's numbers over a short
window (the lower readings) and, with --control, the control's (the
upper readings: the reference in the program's place at the
configuration's narrower precisions, clipper_f64 with CONTROL). Each
seed is also the scene's seed, so the readings cover that many scenes;
with --same-scene 1 the scene stays the configuration's and the seed is
a run's.

    python3 benchmark/calibrate.py --workload align_grid --seeds 1 2 3 [--control] [--program 0]
        [--ops 1] [--fault NAME] [--same-scene 0]

One process reads every seed, so set-up is paid once. Prints a JSON line
per seed and reading. With --fault NAME the program's readings are those
of the program with that fault of benchmark/faults.py planted.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--same-scene", type=int, default=0)
    ap.add_argument("--ops", type=int, default=1, help="operations a seed (a register "
                    "cell calls every pair of its cycle once)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("refused: needs a CUDA card", file=sys.stderr)
        return 3
    from roman_tpu_torch.kernels import build
    build.build_all()
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    wl, config, traffic = harness.find_cell(bench, args.workload)
    mod = harness.entry_module(traffic)
    dev = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            scene = config if args.same_scene else dict(
                config, scene=dict(config["scene"], seed=seed))
            cell = mod.Cell(scene, traffic, seed, dev)
            n = len(cell.pair_i) if traffic["entry"] == "register" else args.ops
            outs = [cell.op(k)[0] for k in range(n)] if args.program else None
        if args.program:
            cell.release()
            t1 = time.perf_counter()
            nums = cell.check(outs)
            reading = f"fault {args.fault}" if args.fault else "program"
            print(json.dumps({"workload": wl["name"], "seed": seed, "reading": reading,
                              "numbers": nums, "setup_and_ops_s": t1 - t0,
                              "reference_s": time.perf_counter() - t1}), flush=True)
        else:
            cell.release()
        if args.control:
            t1 = time.perf_counter()
            nums = cell.control()
            print(json.dumps({"workload": wl["name"], "seed": seed, "reading": "control",
                              "numbers": nums, "seconds": time.perf_counter() - t1}),
                  flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
