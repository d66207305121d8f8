"""The port's tracing: spans and counters at the boundaries of its layers,
on exactly while a torch.profiler session records.

    with tracing.span("engine.call"):
        tracing.count_sync(x.device)   # the host is about to wait for x's card
        x = x.cpu()

With no profiler recording, span() returns the shared no-op OFF and a count
returns at once: one check of the profiler's state each. While one records,
a span is an op-scope event of the profiler's own trace (on the clock of
the device activity: ``demo --profile``'s Chrome trace, the benchmark's raw
events) and a Record kept in memory; counts are kept too. Not
``torch.profiler.record_function``: its user scope also puts a
"gpu_user_annotation" over the span's kernels on the device's timeline,
which a reader of the device trace counts as device work. The outermost
span of a call is its request. ``self_ns`` and ``counter`` give totals since
``reset()``; a span's self time is its duration less its child spans'.
A device count (``count_device``) keeps the tensor it is given and sums it
only when ``counter`` is read, so it adds no wait where it is made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import List, Optional

import torch

_profiling = torch.autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast


@dataclasses.dataclass
class Record:
    """One span: perf_counter_ns() at its start and end (None while open),
    the id of the span it ran inside (None for the outermost) and the id
    of the outermost span around it (its own, for the outermost)."""

    id: int
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request: int


OFF = contextlib.nullcontext()  # the span while no profiler records
_ids = itertools.count()
_lock = threading.Lock()  # guards the counters' read-modify-write
_open = threading.local()  # each thread's stack of open Records
_records: List[Record] = []
_counters: dict = {}
_device_counts: dict = {}  # each counter's tensors not summed yet


class _Span:
    __slots__ = ("name", "_event", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._event = _RecordFunction(self.name)
        self._event.__enter__()
        if not hasattr(_open, "stack"):
            _open.stack = []
        outer = _open.stack[-1] if _open.stack else None
        rid = next(_ids)
        self._record = Record(rid, self.name, time.perf_counter_ns(), None,
                              outer.id if outer else None,
                              outer.request if outer else rid)
        _open.stack.append(self._record)
        _records.append(self._record)

    def __exit__(self, *exc):
        self._record.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        self._event.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether tracing is on: a profiler records."""
    return _profiling()


def span(name: str):
    """A context manager timing `name` while a profiler records; the
    shared no-op OFF otherwise."""
    return _Span(name) if _profiling() else OFF


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a profiler records."""
    if _profiling():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_sync(device: torch.device, n: int = 1) -> None:
    """count("sync", n) where `device` is a CUDA device: the host is about
    to wait for it n times (a blocking copy to or from the card, a result
    checked on the host)."""
    if _profiling() and device.type == "cuda":
        count("sync", n)


def count_device(name: str, values: torch.Tensor) -> None:
    """Add the sum of `values`, a tensor on any device, to counter `name`
    while a profiler records. The tensor is kept, and summed when the
    counter is read."""
    if _profiling():
        with _lock:
            _device_counts.setdefault(name, []).append(values)


def records() -> List[Record]:
    """The spans recorded since the last reset, in the order they began."""
    return list(_records)


def self_ns(name: str) -> int:
    """Total self time of the closed spans named `name`, in ns."""
    done = [r for r in records() if r.end_ns is not None]
    covered = {}
    for r in done:
        if r.parent is not None:
            covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
    return sum(r.end_ns - r.start_ns - covered.get(r.id, 0)
               for r in done if r.name == name)


def counter(name: str) -> int:
    """Total of counter `name` since the last reset; sums its device
    counts (a wait for their devices)."""
    with _lock:
        pending = _device_counts.pop(name, [])
        if pending:
            _counters[name] = _counters.get(name, 0) + sum(int(t.sum()) for t in pending)
        return _counters.get(name, 0)


def reset() -> None:
    """Forget every record and count."""
    _records.clear()
    with _lock:
        _counters.clear()
        _device_counts.clear()
