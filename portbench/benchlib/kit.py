"""What the kinds of traffic share. A kind (``kinds/<kind>.py``, named by a
traffic file's ``kind``) has ``run(cell, seed, seconds, tracer, dev,
fault)``: it builds the system under test from the cell's configuration and
traffic, warms every shape the window uses, runs the window as a closed loop
with one caller, reads the device's peak memory, and returns an `Outcome`
whose `check` compares plain data read from the program's outputs with the
reference (``pbref``)."""

from __future__ import annotations

import contextlib
import sys
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class Outcome:
    window_start: float  # perf_counter at the window's start
    window_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # every end-to-end metric but setup_s
    ctx: dict  # what the per-layer readers read
    memory_peak_bytes: int
    check: Callable[[], Dict[str, int]]  # the comparison with the reference
    info: Dict[str, object] = field(default_factory=dict)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(torch, dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(torch, dev) -> None:
    """Return the program's freed device memory before the reference runs."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def point(C):
    """A commitment's point as (x, y), None at infinity."""
    P = C.point
    return None if P.infinity else (int(P.x), int(P.y))


def ints(v) -> List[int]:
    return [int(x) for x in (v.to_ints() if hasattr(v, "to_ints") else v)]


def csr(M):
    return (list(M.data), list(M.indices), list(M.indptr))


@contextlib.contextmanager
def window(tracer, fault):
    """The window: traced when tracing is on, with `fault` (a context
    manager factory of benchlib.faults) planted when given."""
    with tracer.window(), (fault() if fault else contextlib.nullcontext()):
        yield


def failed(error: BaseException):
    """The check of a window whose call raised: no reference comparison,
    one failed call."""
    traceback.print_exception(error, file=sys.stderr)
    return lambda: {"failed_calls": 1}
