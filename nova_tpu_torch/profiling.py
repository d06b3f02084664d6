"""Wall-clock phase timers for the host path, and a device trace (port of
``nova_tpu/profiling.py``).

Usage:

    from nova_tpu_torch import profiling

    with profiling.phases() as ph:
        with ph("witness"):
            ...
    print(ph.report())

Set NOVA_PROFILE=1 to make the built-in prover phase markers
(``RecursiveSNARK.prove_step``) record into a process-global collector;
read it with ``profiling.global_report()`` or ``profiling._GLOBAL``. A
phase times the host: device work that it queues and does not wait for is
charged to the phase that waits for it.

``device_trace(log_dir)`` records a region with ``torch.profiler`` (host
activity, and the card's kernels when CUDA is available) and writes it to
`log_dir` as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseCollector:
    """Accumulates named wall-clock phases; nestable and reentrant."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:24s} {tot * 1e3:9.1f} ms  x{self.counts[name]}"
            for name, tot in rows
        )

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


_GLOBAL = PhaseCollector()


def enabled() -> bool:
    return bool(os.environ.get("NOVA_PROFILE"))


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Prover-internal phase marker: records into the global collector
    when NOVA_PROFILE=1, otherwise free."""
    if not enabled():
        yield
        return
    with _GLOBAL(name):
        yield


@contextlib.contextmanager
def phases() -> Iterator[PhaseCollector]:
    """A fresh local collector, independent of NOVA_PROFILE. (Context
    form kept for symmetry with the collector's own `with ph(name)`
    usage; exiting the block has no side effects.)"""
    yield PhaseCollector()


def global_report() -> str:
    return _GLOBAL.report()


def global_reset() -> None:
    _GLOBAL.totals.clear()
    _GLOBAL.counts.clear()


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
