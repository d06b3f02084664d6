"""Host (exact, sequential) multi-scalar multiplication.

Reference semantics: src/provider/msm.rs. The host path is used for small
inputs and as the correctness oracle for the device MSMs in
nova_tpu_torch/ops/msm2.py and msm3.py; it implements a plain windowed
Pippenger (the reference's signed-digit and bit-width routing are device-side
optimizations, not semantics). Buckets and sums are kept in Jacobian
coordinates on Python ints (curves with a = 0), so the whole MSM pays one
field inversion; the window count follows the widest scalar given.
"""

from __future__ import annotations

from typing import List, Sequence

from nova_tpu_torch.curves.spec import AffinePoint


def msm_naive(scalars: Sequence[int], bases: Sequence[AffinePoint]) -> AffinePoint:
    assert len(scalars) == len(bases)
    if not bases:
        raise ValueError("empty msm")
    acc = AffinePoint.identity(bases[0].curve)
    for s, b in zip(scalars, bases):
        if s:
            acc = acc.add(b.mul(s))
    return acc


# Jacobian points are (X, Y, Z) tuples of ints, None for the identity.


def _jdbl(P, p: int):
    """dbl-2009-l (a = 0)."""
    X, Y, Z = P
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y * Z % p
    return (X3, Y3, Z3) if Z3 else None


def _jmadd(P, x: int, y: int, p: int):
    """P + (x, y) affine (madd-2007-bl), doubling and P = -Q handled."""
    if P is None:
        return (x, y, 1)
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % p
    U2 = x * Z1Z1 % p
    S2 = y * Z1 % p * Z1Z1 % p
    if U2 == X1:
        return _jdbl(P, p) if S2 == Y1 else None
    H = (U2 - X1) % p
    HH = H * H % p
    I = 4 * HH % p
    J = H * I % p
    r = 2 * (S2 - Y1) % p
    V = X1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
    return (X3, Y3, Z3)


def _jadd(P, Q, p: int):
    """P + Q (add-2007-bl), doubling and P = -Q handled."""
    if P is None:
        return Q
    if Q is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 % p * Z2Z2 % p
    S2 = Y2 * Z1 % p * Z1Z1 % p
    if U1 == U2:
        return _jdbl(P, p) if S1 == S2 else None
    H = (U2 - U1) % p
    I = 4 * H * H % p
    J = H * I % p
    r = 2 * (S2 - S1) % p
    V = U1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * S1 * J) % p
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % p
    return (X3, Y3, Z3)


def _window_for(n: int) -> int:
    return max(2, min(16, n.bit_length() - 3))


def msm(scalars: Sequence[int], bases: Sequence[AffinePoint], window: int = None) -> AffinePoint:
    """Windowed Pippenger (host). The C++ kernel of the native binding takes
    more than 8 bases when it is built; the pure-Python version below takes
    non-negative scalars."""
    assert len(scalars) == len(bases)
    if not bases:
        raise ValueError("empty msm")
    curve = bases[0].curve
    if len(bases) > 8:
        from nova_tpu_torch import native

        if native.available():
            return native.msm(list(scalars), list(bases))
    if len(bases) <= 8:
        return msm_naive(scalars, bases)
    p = curve.base.p
    c = window or _window_for(len(bases))
    pairs = [(int(s), b.x, b.y) for s, b in zip(scalars, bases) if s and not b.infinity]
    num_bits = max((s.bit_length() for s, _, _ in pairs), default=0)
    mask = (1 << c) - 1

    acc = None
    for w in reversed(range((num_bits + c - 1) // c)):
        for _ in range(c):
            if acc is not None:
                acc = _jdbl(acc, p)
        shift = w * c
        buckets: List = [None] * mask
        for s, x, y in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d - 1] = _jmadd(buckets[d - 1], x, y, p)
        running = None
        for bkt in reversed(buckets):
            running = _jadd(running, bkt, p)
            acc = _jadd(acc, running, p)
    if acc is None:
        return AffinePoint.identity(curve)
    X, Y, Z = acc
    zinv = pow(Z, -1, p)
    zinv2 = zinv * zinv % p
    return AffinePoint(curve, X * zinv2 % p, Y * zinv2 % p * zinv % p)
