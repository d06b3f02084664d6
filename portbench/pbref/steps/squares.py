"""The reference's side of the step circuit "squares": z -> z^(2^squares)
a step, one constraint x * x = y a squaring, each y the next x."""

from typing import Dict, List


def z_out(z0: List[int], calls: int, params: dict, p: int) -> List[int]:
    return [pow(z0[0], pow(2, params["squares"] * calls, p - 1), p)]


def _single(M, r):
    """(variable, coefficient) of row r of M when it has one entry."""
    data, indices, indptr = M
    if indptr[r + 1] - indptr[r] != 1:
        return None
    k = indptr[r]
    return indices[k], data[k]


def rows_missing(A, B, C, params: dict) -> int:
    """By how many rows the longest chain of rows x * x = y (every
    coefficient 1, each y the next row's x) differs from `squares`."""
    square: Dict[int, int] = {}
    for r in range(len(A[2]) - 1):
        a, b, c = _single(A, r), _single(B, r), _single(C, r)
        if a and a == b and c and a[1] == 1 and c[1] == 1:
            square[a[0]] = c[0]
    longest, length = 0, {}
    for start in square:
        chain, seen, v = [], set(), start
        while v in square and v not in length and v not in seen:
            chain.append(v)
            seen.add(v)
            v = square[v]
        n = length.get(v, 0)
        for u in reversed(chain):
            n += 1
            length[u] = n
        longest = max(longest, length.get(start, 0))
    return abs(params["squares"] - longest)
