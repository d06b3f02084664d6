"""Multi-scalar multiplication by plain Pippenger on Python integers: the
points are split into one slice per worker process, each slice summed with
unsigned windows of c bits (buckets, then a running sum), and the slices'
sums added."""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Sequence

import numpy as np

from pbref.curves import CURVES, ID, Point, xyzz_add, xyzz_dbl, xyzz_madd, xyzz_to_affine
from pbref.h2c import from_rows


def _window(n: int, bits: int) -> int:
    """The c that minimises windows x (points + 2 x buckets) additions."""
    return min(range(2, 17), key=lambda c: -(-bits // c) * (n + 2 * (1 << c)))


def pippenger(p: int, points, scalars: Sequence[int], bits: int):
    """sum s_i P_i in XYZZ coordinates; points are (x, y) or None."""
    pairs = [(P, s) for P, s in zip(points, scalars) if P is not None and s]
    if not pairs:
        return ID
    c = _window(len(pairs), bits)
    mask = (1 << c) - 1
    acc = ID
    for w in reversed(range(-(-bits // c))):
        for _ in range(c):
            acc = xyzz_dbl(p, acc)
        shift = w * c
        buckets = [None] * (mask + 1)
        for (x, y), s in pairs:
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = xyzz_madd(p, ID if b is None else b, x, y)
        running = total = ID
        for d in range(mask, 0, -1):
            b = buckets[d]
            if b is not None:
                running = xyzz_add(p, running, b)
            total = xyzz_add(p, total, running)
        acc = xyzz_add(p, acc, total)
    return acc


def _part(args):
    curve_name, rows, scal = args
    curve = CURVES[curve_name]
    scalars = [int.from_bytes(scal[32 * i: 32 * i + 32], "little") for i in range(len(rows))]
    return pippenger(curve.p, from_rows(rows), scalars, curve.r.bit_length())


def msm_rows(curve_name: str, rows: np.ndarray, scalars: Sequence[int],
             workers: int = None) -> Point:
    """sum scalars[i] * point(rows[i]) over len(scalars) rows, in `workers`
    processes (all cores by default)."""
    curve = CURVES[curve_name]
    n = len(scalars)
    if n > len(rows):
        raise ValueError(f"{n} scalars for {len(rows)} points")
    workers = max(1, min(workers or os.cpu_count() or 1, n // 256 or 1))
    scal = b"".join((int(s) % curve.r).to_bytes(32, "little") for s in scalars)
    step = -(-n // workers)
    parts = [(curve_name, np.ascontiguousarray(rows[a: a + step]),
              scal[32 * a: 32 * min(a + step, n)]) for a in range(0, n, step)]
    if len(parts) == 1:
        sums = [_part(parts[0])]
    else:
        with ProcessPoolExecutor(len(parts), mp_context=get_context("spawn")) as ex:
            sums = list(ex.map(_part, parts))
    acc = ID
    for s in sums:
        acc = xyzz_add(curve.p, acc, s)
    return xyzz_to_affine(curve.p, acc)
