"""The readings the comparison's limits are set from, on the card, at the
cells' own sizes: for each seed, the program's numbers over a short
window (the lower readings) and, with --control, the control's (the
upper readings: the reference in the program's place at the
configuration's narrower precisions, clipper_f64 with CONTROL). Each
seed is also the scene's seed, so the readings cover that many scenes.

    python3 benchmark/calibrate.py --workload align_grid --seeds 1 2 3 [--control] [--program 0]

One process reads every seed, so set-up is paid once. Prints a JSON line
per seed and reading.
"""

import argparse
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
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

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
        cell = mod.Cell(dict(config, scene=dict(config["scene"], seed=seed)), traffic,
                        seed, dev)
        if args.program:
            # a register cycle calls every pair once; a grid call registers all
            n = len(cell.pair_i) if traffic["entry"] == "register" else 1
            outs = [cell.op(k)[0] for k in range(n)]
            cell.release()
            t1 = time.perf_counter()
            nums = cell.check(outs)
            print(json.dumps({"workload": wl["name"], "seed": seed, "reading": "program",
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
