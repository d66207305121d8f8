"""Run one cell of the port's benchmark from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output and the numbers
compared, beside their limits, as the last lines of standard error. Needs
a CUDA card; without one (or with fewer than the cell asks for) it exits
with code 3 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout
CACHE = os.path.join(ROOT, "build", "bench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process drives the card with one host thread: the cells' host
    # work is Python and small CPU ops, and idle intra-op threads only
    # contend with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # and on two fixed cores where the host has them, which steadied the
    # host-bound cells' runs (PERF.md, section 2)
    if hasattr(os, "sched_setaffinity") and {2, 3} <= os.sched_getaffinity(0):
        os.sched_setaffinity(0, {2, 3})
    sys.path.insert(0, ROOT)
    from benchmark import harness

    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
