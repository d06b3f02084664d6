"""The port's tracer: host-timed spans and counters, and a device trace
(port of ``nova_tpu/profiling.py``).

Spans. ``with profiling.phase(name):`` marks a span of host work. While
tracing is on, each span adds its wall time to a per-name total in the
process-global collector (``profiling._GLOBAL.totals``, with ``.counts``).
While a recorder is active (``start_spans()`` ... ``take_spans()``), each
span is also kept as ``(start_ns, end_ns, name, parent)``: start and end on
``time.perf_counter_ns()``, ``parent`` the index in the same list of the
span that was open around it (None at the top). Spans nest; their names are
flat (``nifs_primary`` > ``nifs.cross_term`` > ``spmv``). A span times the
host only: device work that it queues and does not wait for is charged to
the span that waits for it. One thread records at a time.

Counters. ``profiling.count(name, n)`` adds `n` to a per-name counter in the
same collector while tracing is on; ``counters()`` returns a copy.

Both are free when tracing is off: ``phase`` and ``count`` then check one
module-level flag and return; they never read the environment, synchronise
the device or copy from it.

For operators: set ``NOVA_PROFILE=1`` before the process starts to turn
tracing on (``enable()`` switches it at run time; ``start_spans()`` turns it
on too). ``global_report()`` prints the totals and the counters;
``global_reset()`` clears them.

``device_trace(log_dir)`` records a region with ``torch.profiler`` (host
activity, and the card's kernels when CUDA is available) and writes it to
`log_dir` as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

Span = Tuple[int, int, str, Optional[int]]


class PhaseCollector:
    """Per-name span totals (seconds) and calls, and counters."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{name:24s} {tot * 1e3:9.1f} ms  x{self.counts[name]}"
                 for name, tot in rows]
        lines += [f"{name:24s} {n:12d}" for name, n in sorted(self.counters.items())]
        return "\n".join(lines)

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()


_GLOBAL = PhaseCollector()
_on = bool(os.environ.get("NOVA_PROFILE"))
_spans: Optional[list] = None  # the recorder's list while one is active
_open: List[int] = []  # indices in _spans of the spans open now


class _Off:
    """What ``phase`` returns while tracing is off: enters and exits."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "rec", "idx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.rec = rec = _spans
        self.t0 = time.perf_counter_ns()
        if rec is not None:
            self.idx = len(rec)
            rec.append([self.t0, None, self.name, _open[-1] if _open else None])
            _open.append(self.idx)

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _GLOBAL.totals[self.name] += (t1 - self.t0) * 1e-9
        _GLOBAL.counts[self.name] += 1
        if self.rec is not None:
            self.rec[self.idx][1] = t1
            if self.rec is _spans and _open and _open[-1] == self.idx:
                _open.pop()
        return False


def enabled() -> bool:
    return _on


def enable(on: bool = True) -> None:
    """Turn tracing on or off for the process."""
    global _on
    _on = bool(on)


def phase(name: str):
    """A span `name` around a block: ``with profiling.phase(name): ...``."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if _on:
        _GLOBAL.counters[name] += n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_GLOBAL.counters)


def start_spans() -> None:
    """Turn tracing on and keep every span from now on, until take_spans."""
    global _spans
    enable()
    _spans = []
    _open.clear()


def take_spans() -> List[Span]:
    """Stop keeping spans and hand over those kept, in the order they
    started; a span still open ends now. Tracing stays on."""
    global _spans
    rec, _spans = _spans or [], None
    _open.clear()
    now = time.perf_counter_ns()
    return [(a, now if b is None else b, name, parent) for a, b, name, parent in rec]


def global_report() -> str:
    return _GLOBAL.report()


def global_reset() -> None:
    _GLOBAL.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace around a region, written to
    ``<log_dir>/trace_<pid>_<ns>.json`` when the region exits."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
