"""Host (exact, sequential) multi-scalar multiplication.

Reference semantics: src/provider/msm.rs. The host path is used for small
inputs and as the correctness oracle for the device MSM in nova_tpu_torch/ops/msm3.py;
it implements a plain windowed Pippenger (the reference's signed-digit and
bit-width routing are device-side optimizations, not semantics).
"""

from __future__ import annotations

from typing import List, Sequence

from nova_tpu_torch.curves.spec import AffinePoint, CurveSpec


def msm_naive(scalars: Sequence[int], bases: Sequence[AffinePoint]) -> AffinePoint:
    assert len(scalars) == len(bases)
    if not bases:
        raise ValueError("empty msm")
    acc = AffinePoint.identity(bases[0].curve)
    for s, b in zip(scalars, bases):
        if s:
            acc = acc.add(b.mul(s))
    return acc


def msm(scalars: Sequence[int], bases: Sequence[AffinePoint], window: int = 8) -> AffinePoint:
    """Windowed Pippenger (host, pure Python)."""
    assert len(scalars) == len(bases)
    if not bases:
        raise ValueError("empty msm")
    curve = bases[0].curve
    if len(bases) <= 8:
        return msm_naive(scalars, bases)

    num_bits = curve.scalar.num_bits
    num_windows = (num_bits + window - 1) // window
    mask = (1 << window) - 1

    window_sums: List[AffinePoint] = []
    for w in range(num_windows):
        shift = w * window
        buckets = [None] * ((1 << window) - 1)
        for s, b in zip(scalars, bases):
            if b.infinity:
                continue
            d = (s >> shift) & mask
            if d:
                buckets[d - 1] = b if buckets[d - 1] is None else buckets[d - 1].add(b)
        running = AffinePoint.identity(curve)
        total = AffinePoint.identity(curve)
        for bkt in reversed(buckets):
            if bkt is not None:
                running = running.add(bkt)
            total = total.add(running)
        window_sums.append(total)

    acc = AffinePoint.identity(curve)
    for ws in reversed(window_sums):
        for _ in range(window):
            acc = acc.double()
        acc = acc.add(ws)
    return acc
