"""The benchmark's own spans, and the reading of a profiler trace.

:class:`Spans` records host-clock spans that the benchmark's files open
around their calls into the program's layers (the program has no spans
of its own yet). :func:`read_profile` turns a ``torch.profiler`` session
over the measured window into what the per-layer metrics read: the
device time of each kernel, the device's busy time as the union of its
kernel, copy and set intervals (two streams that overlap count once), and
the breakdown of device operations and idle gaps.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple


class Spans:
    """Named host-clock spans: durations in seconds, by name."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)

    def clear(self) -> None:
        self.seconds.clear()


class TimedIterator:
    """Wraps an iterator; each ``next()`` is a span of ``name``. ``keep``
    receives the first ``keep_max`` items it yields (for the correctness
    check); ``alter``, where given, changes each item (a planted fault)."""

    def __init__(self, it, spans: Spans, name: str, keep: Optional[list] = None,
                 keep_max: int = 0, alter=None):
        self.it = iter(it)
        self.spans = spans
        self.name = name
        self.keep = keep
        self.keep_max = keep_max
        self.alter = alter

    def __iter__(self):
        return self

    def __next__(self):
        with self.spans.span(self.name):
            item = next(self.it)
        if self.alter is not None:
            item = self.alter(item)
        if self.keep is not None and len(self.keep) < self.keep_max:
            self.keep.append(item)
        return item


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """Total length of the union of [start, end) intervals, and the gaps
    between the merged runs."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _gaps_by_next_op(dev_events, gaps, limit: int = 10):
    """Sum each idle gap under the device operation that ends it: the
    work the host was preparing while the card waited (the trace holds
    device activity only, which keeps the host's cost of tracing low).
    -> the longest ``limit`` (name, seconds) pairs."""
    starts = sorted((s, n) for s, _, n in dev_events)
    keys = [s for s, _ in starts]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_left(keys, g1)
        name = starts[i][1] if i < len(starts) else "end of window"
        out["before " + name[:120]] += (g1 - g0) / 1e6
    top = sorted(out.items(), key=lambda kv: -kv[1])[:limit]
    return [[n, s] for n, s in top]


def read_profile(prof, window_s: float) -> dict:
    """-> {"kernels": {name: device seconds}, "busy_s", "window_s",
    "device_ops", "idle_gaps"} from a finished
    ``torch.profiler.profile`` over a window of ``window_s`` seconds."""
    import torch

    kernels: Dict[str, float] = collections.defaultdict(float)
    dev = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            tr = ev.time_range
            kernels[ev.name] += tr.elapsed_us() / 1e6
            dev.append((tr.start, tr.end, ev.name))
    busy_us, gaps = _union([(s, e) for s, e, _ in dev])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": dict(kernels), "busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": _gaps_by_next_op(dev, gaps)}
