"""The harness: finds a cell's configuration, traffic and metrics by name,
sets the cell up, measures a window of operations, checks the answers
against the reference and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name in BENCHMARK.json:

- configs/<config>.json      the configuration as it is run;
- traffic/<traffic>.json     the mix: which entry drives the port
                             (entries/<entry>.py), its parameters, and the
                             end-to-end statistic it reports;
- metrics/<metric>.py        a reader `read(ctx, name)` returning a number or
                             None; a name with a dot falls back to the
                             reader named by its part before the first dot
                             (idle_share.grid -> metrics/idle_share.py);
- limits/<workload>.json     the limit of each number the comparison reads.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "roman_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str):
    """(workload entry, configuration, traffic) of a cell by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(ROOT, files[cell["config"]])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    return cell, config, traffic


def entry_module(traffic: dict):
    return importlib.import_module(f"benchmark.entries.{traffic['entry']}")


def metric_reader(name: str):
    """The module whose read(ctx) gives per-layer metric `name`."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} under metrics/")


def cell_metrics(bench: dict, workload: str, kind: str, reported: set) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports: those listing it, and those without a list whose moved
    metric (per-layer) the cell reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in reported:
            out.append(m)
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    cell: object             # the entry's Cell (its work counts)
    trace: object            # trace.Trace of the profiled stretch


@dataclasses.dataclass
class Window:
    outputs: list
    seconds: list            # each operation's host time
    units: int
    elapsed: float
    trace: object = None


def measure(cell, seconds: float, trace_spec: dict = None, sync=None) -> Window:
    """Operations back to back for `seconds` (the last one finishes), each
    inside the benchmark's span. With trace_spec, the profiler records a
    stretch of trace_spec["span_ops"] operations starting with the first
    one after trace_spec["lead_s"] seconds; the trace is read after the
    window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as trace_mod

    outputs, times, units = [], [], 0
    prof, traced, state = None, 0, "before"

    def stop():
        if sync:
            sync()
        prof.__exit__(None, None, None)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if (trace_spec and state == "before"
                and time.perf_counter() - t0 >= trace_spec["lead_s"]):
            if sync:
                sync()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            state = "on"
        ts = time.perf_counter()
        with record_function(trace_mod.SPAN):
            out, n = cell.op(len(outputs))
        times.append(time.perf_counter() - ts)
        outputs.append(out)
        units += n
        if state == "on":
            traced += 1
            if traced >= trace_spec["span_ops"]:
                stop()
                state = "done"
    elapsed = time.perf_counter() - t0
    if state == "on":  # the window closed inside the stretch
        stop()
    if trace_spec and prof is None:
        raise RuntimeError("the window closed before the traced stretch began")
    return Window(outputs=outputs, seconds=times, units=units, elapsed=elapsed,
                  trace=trace_mod.read(prof) if prof is not None else None)


def end_to_end(traffic: dict, w: Window) -> dict:
    """The traffic's reported statistics over the whole window."""
    out = {}
    for name, stat in traffic["report"].items():
        if stat == "rate":
            out[name] = w.units / w.elapsed
        elif stat == "p95_ms":
            out[name] = float(np.percentile(np.asarray(w.seconds) * 1e3, 95))
        else:
            raise ValueError(f"unknown statistic {stat!r} for {name}")
    return out


def nvidia_smi() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    """One run of a cell on cuda:0; prints the result line and returns the
    exit code (3, and no result, without enough cards)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, config, traffic = find_cell(bench, workload)
    return run_cell(bench, wl, config, traffic, seed, seconds, trace, t_start)


def reported_metrics(bench, wl, cell, traffic, w: Window, setup_s: float,
                     trace: bool) -> dict:
    """The result line's metrics: the cell's end-to-end metrics, or with
    trace its per-layer metrics (those whose reader finds something)."""
    e2e = end_to_end(traffic, w)
    e2e["setup_s"] = setup_s
    metrics = {}
    if not trace:
        for m in cell_metrics(bench, wl["name"], "end_to_end", set()):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        return metrics
    ctx = Context(cell=cell, trace=w.trace)
    for m in cell_metrics(bench, wl["name"], "per_layer", set(e2e)):
        value = metric_reader(m["name"]).read(ctx, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(bench, wl, config, traffic, seed, seconds, trace, t_start,
             device=None) -> int:
    """run() on a found cell; a test passes a CPU device to rehearse the
    rest of a run, which then reports no metric."""
    import torch

    from benchmark import trace as trace_mod
    from benchmark.reference import compare

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"refused: {wl['name']} needs {wl['chips']} CUDA card(s), "
                  f"this host has {n}", file=sys.stderr)
            return 3
        device = "cuda:0"
        print(f"card: {nvidia_smi()}", file=sys.stderr, flush=True)
        from roman_tpu_torch.kernels import build
        build.build_all()
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else None

    if on_card:
        torch.set_num_threads(1)
    cell = entry_module(traffic).Cell(config, traffic, seed, device)
    if sync:
        sync()
    # what set-up made stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    print(f"setup: {setup_s:.3f} s", file=sys.stderr, flush=True)

    w = measure(cell, seconds, traffic["trace"] if trace else None, sync)
    found = forbidden_modules()
    ms = np.percentile(np.asarray(w.seconds) * 1e3, [0, 50, 95, 100])
    print(f"window: {len(w.outputs)} operations, {w.units} {cell.unit}, {w.elapsed:.3f} s; "
          f"operation ms min {ms[0]:.3f} median {ms[1]:.3f} p95 {ms[2]:.3f} max {ms[3]:.3f}; "
          f"{cell.describe()}", file=sys.stderr, flush=True)
    if w.trace is not None:
        print(f"traced stretch: {w.trace.n_ops} operations, "
              f"{trace_mod.setup_calls(w.trace)} graph captures or module loads",
              file=sys.stderr, flush=True)
    if on_card:
        print(f"card after the window: {nvidia_smi()}", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()

    verdict = compare.judge(cell.check(w.outputs),
                            load_json(HERE, "limits", wl["name"] + ".json"))
    metrics = (reported_metrics(bench, wl, cell, traffic, w, setup_s, trace)
               if on_card else {})
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        print(f"refused: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": all(ok for *_, ok in verdict), "attempted": len(w.outputs),
            "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in w.trace.device_ops],
                             "idle_gaps": [list(x) for x in w.trace.idle_gaps]}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in verdict}
    for name, v, lim, ok in verdict:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
