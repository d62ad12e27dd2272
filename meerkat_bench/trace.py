"""Spans and the device trace of one run, kept in memory.

* :class:`Spans`: host spans (``perf_counter``) and device spans (a pair of
  CUDA events, read once the window has closed) the harness records around
  its calls into the program's layers.
* :class:`DeviceTrace`: ``torch.profiler`` over a traced window, reduced to
  the device's kernels (name, start, end), the host's labelled ranges, the
  device's busy seconds and the breakdown the result line carries.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.host = defaultdict(list)     # name -> [seconds]
        self._events = defaultdict(list)  # name -> [(start, end, weight)]

    def device_span(self, name: str, weight: float = 1.0):
        """A pair of CUDA events around a call (no sync): ``with``."""
        spans = self

        class _Span:
            def __enter__(self):
                if spans.cuda:
                    self.a = torch.cuda.Event(enable_timing=True)
                    self.a.record()
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                if spans.cuda:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                    spans._events[name].append((self.a, b, weight))
                spans.host[name].append(time.perf_counter() - self.t)
        return _Span()

    def device_ms(self, name: str):
        """[(ms, weight)] of the device spans ``name`` (syncs once)."""
        ev = self._events.get(name, [])
        if ev:
            torch.cuda.synchronize()
        return [(a.elapsed_time(b), w) for a, b, w in ev]


def _ns(e, attr):
    if hasattr(e, attr + "_ns"):
        return getattr(e, attr + "_ns")()
    return getattr(e, attr + "_us")() * 1000


class DeviceTrace:
    """``torch.profiler`` over a window that the caller opens and closes
    (``start``/``stop``); host work inside it is labelled with
    ``label(name)`` (``record_function``)."""

    WINDOW = "bench.window"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.kernels = []   # (name, start_ns, end_ns), device
        self.ranges = []    # (name, start_ns, end_ns), host labels
        self.window = None  # (start_ns, end_ns)

    @staticmethod
    def label(name: str):
        from torch.profiler import record_function
        return record_function(name)

    @staticmethod
    def warm():
        """Start and stop a profiler once, so that its set-up (CUPTI's)
        is paid in the run's set-up and not inside the traced window."""
        t = DeviceTrace()
        t.start()
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
        t.stop()

    def start(self):
        self.prof.__enter__()
        self._win = self.label(self.WINDOW)
        self._win.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            on_device = str(e.device_type()).endswith("CUDA")
            kind = str(e.activity_type()) if hasattr(e, "activity_type") \
                else ""
            if on_device and "annotation" not in kind \
                    and not e.name().startswith("bench."):
                self.kernels.append((e.name(), start, end))
            elif on_device:
                continue   # the host labels' shadows on the device
            elif e.name() == self.WINDOW:
                self.window = (start, end)
            elif e.name().startswith("bench."):
                self.ranges.append((e.name(), start, end))
        self.prof = None

    # --------------------------------------------------------- reductions --
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """Device intervals with something running, merged, clipped to the
        window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, match) -> tuple:
        """(seconds, count) of the device kernels whose name ``match``
        accepts."""
        lo, hi = self.window
        tot, n = 0, 0
        for name, s, e in self.kernels:
            if e > lo and s < hi and match(name):
                tot += min(e, hi) - max(s, lo)
                n += 1
        return tot * 1e-9, n

    def top_ops(self, k: int = 10):
        by = defaultdict(int)
        for name, s, e in self.kernels:
            by[name[:120]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10):
        """Idle device time by the innermost host label open when each gap
        began (``host`` where none was), largest first."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        ranges = sorted(self.ranges, key=lambda r: r[1])
        starts = [r[1] for r in ranges]
        by = defaultdict(int)
        for s, e in gaps:
            label = "host"
            # the latest-starting label that still covers the gap's start
            for j in range(bisect.bisect_right(starts, s) - 1,
                           max(-1, bisect.bisect_right(starts, s) - 65), -1):
                if ranges[j][2] >= s:
                    label = ranges[j][0]
                    break
            by[label] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-9] for n, v in top]
