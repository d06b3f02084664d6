"""The traced run's device view: ``torch.profiler`` over the window with
the device's activity only (kernels, copies, memsets; no host operators, so
the trace costs the host little), its Chrome trace reduced to the device's
busy time, the device time inside each harness span, and the breakdown (the
device operations that took most time, and the longest idle gaps by the
innermost span the host was in).

The trace covers the window's first TRACE_SECONDS (or all of a shorter
one), so that a run reads it in well under a minute. That part and the
spans are timed on the host's clock by the harness and placed on the
trace's clock by two marker kernels, one launched just before the window
opens and one just after the trace closes, each after the device went idle:
the host's launch time of a marker and its start in the trace give the two
clocks' offset, the two markers the rate."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96  # a breakdown entry's name; templated kernels run to hundreds
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000
TRACE_SECONDS = 15.0  # the traced part of the window


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def _innermost(spans, w0: float, w1: float):
    """The window cut into [start, end, name] segments, each named by the
    innermost span open there ("host" where none is), spans being nested."""
    ev = []
    for i, (a, b, name) in enumerate(spans):
        ev.append((a, 1, -(b - a), i))
        ev.append((b, 0, 0.0, i))
    ev.sort()
    segs, stack, t = [], [], w0
    for x, kind, _, i in ev:
        x = min(max(x, w0), w1)
        if x > t:
            segs.append((t, x, spans[stack[-1]][2] if stack else "host"))
            t = x
        if kind:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if w1 > t:
        segs.append((t, w1, spans[stack[-1]][2] if stack else "host"))
    return segs


def reduce_events(events: List[dict], window: Tuple[float, float],
                  spans: List[Tuple[float, float, str]]) -> dict:
    """The numbers the readers use, from Chrome trace events and the window
    and the harness's spans (start, end, name), all in the trace's
    microseconds: window_s, busy_s, span_device_s {name: (device seconds,
    count)} with kernels counted inside the span they ran in, and the
    breakdown."""
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS:
            ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
            dev.append((ts, ts + dur, e["cat"], e.get("name", "")))
    w0, w1 = window
    busy = _union(_clip([(a, b) for a, b, _, _ in dev], w0, w1))
    by_op: Dict[str, float] = defaultdict(float)
    kernels = []
    for a, b, cat, name in dev:
        if b > w0 and a < w1:
            by_op[name] += (min(b, w1) - max(a, w0)) * 1e-6
            if cat == "kernel":
                kernels.append((a, b))
    kernels.sort()
    span_dev: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    starts = [a for a, _ in kernels]
    for a, b, name in spans:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        inside = _union(_clip(kernels[lo:hi], a, b))
        span_dev[name][0] += sum(y - x for x, y in inside) * 1e-6
        span_dev[name][1] += 1
    gaps: Dict[str, float] = defaultdict(float)
    idle = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle.append((a, b))
    segs = _innermost(spans, w0, w1)
    j = 0
    for a, b in idle:  # both sorted: split each idle gap over the spans it meets
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi, name = segs[k]
            gaps[name] += (min(b, hi) - max(a, lo)) * 1e-6
            k += 1

    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "span_device_s": {k: tuple(v) for k, v in span_dev.items()},
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)},
    }


def markers(events: List[dict]) -> List[Tuple[float, float]]:
    """(start, end) of the marker kernels in the trace, in order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel" and MARKER in e.get("name", ""))


def place(events: List[dict], host_marks: Tuple[int, int], host_window: Tuple[int, int]):
    """(the traced window in the trace's microseconds, the map from the
    host's perf_counter_ns to them). host_marks are the launch times of the
    start and the end marker; each is the last kernel of the markers before
    the window's device work, or the first after it (a marker launched
    before each, and one after the end marker, may go unrecorded). With
    both markers the map takes each launch to its marker's start; with one
    (or two whose clocks differ in rate by more than 0.1%), the clocks are
    taken to run at the same rate."""
    m = markers(events)
    others = sorted(float(e["ts"]) for e in events if e.get("ph") == "X"
                    and e.get("cat") in DEVICE_CATS and MARKER not in e.get("name", ""))
    if others:
        cut = others[len(others) // 2]
    elif len(m) > 1:
        gaps = [(m[k + 1][0] - m[k][0], k) for k in range(len(m) - 1)]
        cut = m[max(gaps)[1] + 1][0]
    else:
        cut = float("inf")
    start = [x for x in m if x[0] < cut]
    end = [x for x in m if x[0] >= cut]
    (h0, h1), (w0, w1) = host_marks, host_window
    if start and end:
        rate = (end[0][0] - start[-1][0]) / ((h1 - h0) * 1e-3)
        if 0.999 < rate < 1.001:
            to_us = lambda ns: start[-1][0] + (ns - h0) * 1e-3 * rate  # noqa: E731
            return (start[-1][1], end[0][0]), to_us
        print(f"portbench: the markers' clocks differ in rate ({rate}); "
              "the window is placed by its start marker alone", file=sys.stderr)
    if start:
        to_us = lambda ns: start[-1][0] + (ns - h0) * 1e-3  # noqa: E731
        return (start[-1][1], to_us(w1)), to_us
    if end:
        to_us = lambda ns: end[0][0] + (ns - h1) * 1e-3  # noqa: E731
        return (to_us(w0), end[0][0]), to_us
    raise RuntimeError("no marker kernel in the trace")


class Tracer:
    """The harness's spans and the traced window's reduced trace in
    `result` (None on a device without CUDA). The trace covers the window's
    first `seconds`: the span that passes them closes it, so that reading
    the trace stays short; the window itself runs on."""

    def __init__(self, enabled: bool, seconds: float = TRACE_SECONDS):
        self.enabled = enabled
        self.seconds = seconds
        self.spans: List[Tuple[int, int, str]] = []
        self.result = None
        self._prof = None
        self._times = {}

    def span(self, name: str):
        return self._span(name) if self._prof is not None else contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name: str):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self.spans.append((t, t1, name))
            if (t1 - self._times["w0"]) * 1e-9 >= self.seconds:
                self._stop()

    @staticmethod
    def _mark() -> int:
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        return t

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._times["w1"] = time.perf_counter_ns()
        self._times["h1"] = self._mark()
        self._mark()
        self._prof.stop()
        self._done, self._prof = self._prof, None

    @contextlib.contextmanager
    def window(self):
        import torch

        if not self.enabled or not torch.cuda.is_available():
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        self.spans = []
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._mark()
        self._times = {"h0": self._mark(), "w0": time.perf_counter_ns()}
        try:
            yield
        finally:
            if self._prof is not None:
                self._stop()
        t = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._done.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        ts = self._times
        window, to_us = place(events, (ts["h0"], ts["h1"]), (ts["w0"], ts["w1"]))
        self.result = reduce_events(events, window,
                                    [(to_us(a), to_us(b), n) for a, b, n in self.spans])
        print(f"portbench: traced {self.result['window_s']:.3f} s of the window, "
              f"{len(events)} trace events read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
