"""Reading a torch.profiler trace of a stretch of operations: the device
intervals, their union, the kernels that took most time and the longest
idle gaps, labelled by what the host was doing; and, by the name of a
host event such as one of the program's spans, the device time of the
work launched inside it (``launched_in``) and the runtime calls that
capture a CUDA graph or load a module (``setup_calls``).

Only the profiler's raw events are read (``kineto_results.events()``):
building its FunctionEvent tree for a stretch of hundreds of calls takes
minutes.
"""

from __future__ import annotations

import bisect
import dataclasses

SPAN = "bench.op"   # the benchmark's span round each operation
# runtime calls that capture or instantiate a CUDA graph, or load a module
# (a kernel built or loaded): none belongs in a measured window
SETUP_CALLS = ("cudaStreamBeginCapture", "cudaStreamEndCapture", "cudaGraphInstantiate",
               "cuModuleLoad", "cuLibraryLoad", "nvrtcCompileProgram")


@dataclasses.dataclass
class Trace:
    window_s: float          # first operation's start to last one's end
    busy_s: float            # union of the device intervals in the window
    n_ops: int
    kernels: int             # device kernel events (no copies or sets)
    device_ops: list         # [(name, seconds)] by summed device time
    idle_gaps: list          # [(host activity, seconds)] longest first
    # the stretch's host events [(start ns, end ns, name)], and its device
    # intervals [(start ns, end ns, start ns of the host call that launched
    # them, None where the trace holds no such call)], for launched_in
    host: list = dataclasses.field(default_factory=list, repr=False)
    launched: list = dataclasses.field(default_factory=list, repr=False)


def _union(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read(prof, top: int = 10) -> Trace:
    """The trace of a profiled stretch whose operations each ran inside a
    record_function(SPAN)."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.device_type() == DeviceType.CPU and e.name() == SPAN]
    if not spans:
        raise RuntimeError("the profiled stretch holds no operation span")
    t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
    # the device side of the benchmark's own span (a GPU user annotation)
    # is no device work
    dev = [(max(e.start_ns(), t0), min(e.start_ns() + e.duration_ns(), t1), e.name())
           for e in events if e.device_type() == DeviceType.CUDA and e.name() != SPAN]
    dev = [d for d in dev if d[1] > d[0]]
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    kernels = sum(1 for *_, name in dev if not name.startswith(("Memcpy", "Memset")))
    # idle gaps between device intervals, labelled by the innermost host
    # event running at the gap's middle
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == DeviceType.CPU]
    gaps, end = [], t0
    for s, e, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        running = [h for h in host if h[0] <= mid < h[1]]
        label = min(running, key=lambda h: h[1] - h[0])[2] if running else "host outside any event"
        idle.append((label, (e - s) / 1e9))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # a device event's launch, matched by the profiler's correlation id (a
    # CUDA graph's kernels carry the id of the graph's launch)
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU and e.correlation_id()
              and e.name().startswith(("cuda", "cu"))}
    launched = [(e.start_ns(), e.start_ns() + e.duration_ns(), launch.get(e.correlation_id()))
                for e in events if e.device_type() == DeviceType.CUDA and e.name() != SPAN]
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=_union([(s, e) for s, e, _ in dev]) / 1e9,
                 n_ops=len(spans), kernels=kernels,
                 device_ops=[(name[:120], ns / 1e9) for name, ns in ops], idle_gaps=idle,
                 host=host, launched=launched)


def launched_in(trace: Trace, name: str):
    """(number of host events named `name`, seconds): the union of the
    device intervals of the work (kernels, copies, sets) launched while one
    of them ran, such as one of the program's spans (an op-scope event of
    the profiler's trace); (0, 0.0) where the stretch holds none."""
    calls = sorted((s, e) for s, e, n in trace.host if n == name)
    merged = []  # nested or overlapping calls as one interval
    for s, e in calls:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    mine = []
    for s, e, t in trace.launched:
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= merged[i][1]:
            mine.append((s, e))
    return len(calls), _union(mine) / 1e9


def setup_calls(trace: Trace) -> int:
    """The stretch's runtime calls that capture or instantiate a CUDA graph
    or load a module (SETUP_CALLS)."""
    return sum(1 for *_, n in trace.host if n.startswith(SETUP_CALLS))
