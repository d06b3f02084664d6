"""Shared harness for the bench grids (the twin of ``benches/common.py``):
one JSON line per configuration, ``--sizes`` / ``--quick``, and the
grids' seeded generator. The device comes from ``_env.entry_device``: the
card, or the CPU when the caller passes ``device="cpu"``; where the JAX
harness pins the CPU when no accelerator answers, these raise."""

from __future__ import annotations

import argparse
import json
import random
import time


def emit(bench: str, config: str, seconds: float, extra=None) -> dict:
    """Print one configuration's JSON line; returns the row."""
    row = {"bench": bench, "config": config, "time_s": round(seconds, 4)}
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def timeit(fn, iters: int = 1) -> float:
    """Mean wall seconds of fn() over `iters` calls. Every timed call ends
    by reading its result on the host (a commitment, a proof), which waits
    for the card."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def parse_args(default_sizes, argv=None):
    """(sizes, args) from `argv` (the command line unless given)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=str, default=None,
                    help="comma-separated log2 sizes")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes = default_sizes[:1] if args.quick else default_sizes
    return sizes, args


def rng(seed: int = 0xBE2C) -> random.Random:
    return random.Random(seed)
