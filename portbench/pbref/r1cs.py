"""Relaxed R1CS satisfiability, row by row: (A z) * (B z) = u (C z) + E over
the prime p, with z = (W, u, X) and each matrix in CSR form
(data, indices, indptr)."""

from __future__ import annotations

from typing import Sequence, Tuple

CSR = Tuple[Sequence[int], Sequence[int], Sequence[int]]


def _row(M: CSR, r: int, z: Sequence[int]) -> int:
    data, indices, indptr = M
    acc = 0
    for k in range(indptr[r], indptr[r + 1]):
        acc += data[k] * z[indices[k]]
    return acc


def unsat_rows(p: int, A: CSR, B: CSR, C: CSR, W: Sequence[int], u: int,
               X: Sequence[int], E: Sequence[int] = None) -> int:
    """The number of rows the relaxed instance (W, E, u, X) breaks; E = 0
    when None (a strict instance has u = 1 and no E)."""
    z = list(W) + [u] + list(X)
    rows = len(A[2]) - 1
    bad = 0
    for r in range(rows):
        e = 0 if E is None else E[r]
        if (_row(A, r, z) * _row(B, r, z) - u * _row(C, r, z) - e) % p:
            bad += 1
    return bad
