"""Short Weierstrass curves y^2 = x^3 + b of the benchmark's configurations,
on Python integers. A point is an (x, y) pair or None for the identity."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

P_PALLAS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q_PALLAS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
P_BN254 = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
Q_BN254 = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

Point = Optional[Tuple[int, int]]


@dataclass(frozen=True)
class Curve:
    name: str
    p: int  # base field modulus
    r: int  # group order (the scalar field)
    b: int
    gen: Point = None

    def on_curve(self, P: Point) -> bool:
        if P is None:
            return True
        x, y = P
        return (y * y - x * x * x - self.b) % self.p == 0


CURVES = {
    "pallas": Curve("pallas", P_PALLAS, Q_PALLAS, 5),
    "vesta": Curve("vesta", Q_PALLAS, P_PALLAS, 5),
    "bn254": Curve("bn254", P_BN254, Q_BN254, 3, (1, 2)),
    "grumpkin": Curve("grumpkin", Q_BN254, P_BN254, Q_BN254 - 17),
}


_TS = {}


def _ts_consts(p: int):
    if p not in _TS:
        s, t = 0, p - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        _TS[p] = (s, t, pow(z, t, p))
    return _TS[p]


def sqrt(x: int, p: int) -> Optional[int]:
    """A square root of x mod the prime p (Tonelli-Shanks), or None."""
    x %= p
    if x == 0:
        return 0
    if p % 4 == 3:
        r = pow(x, (p + 1) // 4, p)
        return r if r * r % p == x else None
    m, t, c = _ts_consts(p)
    w = pow(x, (t - 1) // 2, p)
    r = x * w % p  # x^((t + 1) / 2)
    u = r * w % p  # x^t
    while u != 1:
        i, v = 0, u
        while v != 1:
            v, i = v * v % p, i + 1
            if i == m:
                return None  # x is not a square
        bb = c
        for _ in range(m - i - 1):
            bb = bb * bb % p
        m, c, r, u = i, bb * bb % p, r * bb % p, u * bb * bb % p
    return r


def add(curve: Curve, P: Point, Q: Point) -> Point:
    """Affine addition (one inversion)."""
    if P is None:
        return Q
    if Q is None:
        return P
    p = curve.p
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


# XYZZ coordinates (x = X/ZZ, y = Y/ZZZ; ZZ = 0 is the identity), a = 0.
ID = (1, 1, 0, 0)


def xyzz_dbl(p: int, P):
    X1, Y1, ZZ1, ZZZ1 = P
    if ZZ1 == 0 or Y1 == 0:
        return ID
    U = 2 * Y1 % p
    V = U * U % p
    W = U * V % p
    S = X1 * V % p
    M = 3 * X1 * X1 % p
    X3 = (M * M - 2 * S) % p
    return X3, (M * (S - X3) - W * Y1) % p, V * ZZ1 % p, W * ZZZ1 % p


def xyzz_madd(p: int, P, x2: int, y2: int):
    """P + (x2, y2), the second point affine and not the identity."""
    X1, Y1, ZZ1, ZZZ1 = P
    if ZZ1 == 0:
        return x2, y2, 1, 1
    U2 = x2 * ZZ1 % p
    S2 = y2 * ZZZ1 % p
    PP_ = (U2 - X1) % p
    R = (S2 - Y1) % p
    if PP_ == 0:
        return xyzz_dbl(p, (x2, y2, 1, 1)) if R == 0 else ID
    PP = PP_ * PP_ % p
    PPP = PP_ * PP % p
    Q = X1 * PP % p
    X3 = (R * R - PPP - 2 * Q) % p
    return X3, (R * (Q - X3) - Y1 * PPP) % p, ZZ1 * PP % p, ZZZ1 * PPP % p


def xyzz_add(p: int, P, Q):
    X1, Y1, ZZ1, ZZZ1 = P
    X2, Y2, ZZ2, ZZZ2 = Q
    if ZZ1 == 0:
        return Q
    if ZZ2 == 0:
        return P
    U1 = X1 * ZZ2 % p
    U2 = X2 * ZZ1 % p
    S1 = Y1 * ZZZ2 % p
    S2 = Y2 * ZZZ1 % p
    PP_ = (U2 - U1) % p
    R = (S2 - S1) % p
    if PP_ == 0:
        return xyzz_dbl(p, P) if R == 0 else ID
    PP = PP_ * PP_ % p
    PPP = PP_ * PP % p
    Q_ = U1 * PP % p
    X3 = (R * R - PPP - 2 * Q_) % p
    return (X3, (R * (Q_ - X3) - S1 * PPP) % p,
            ZZ1 * ZZ2 % p * PP % p, ZZZ1 * ZZZ2 % p * PPP % p)


def xyzz_to_affine(p: int, P) -> Point:
    X, Y, ZZ, ZZZ = P
    if ZZ == 0:
        return None
    return X * pow(ZZ, -1, p) % p, Y * pow(ZZZ, -1, p) % p


def mul(curve: Curve, P: Point, k: int) -> Point:
    """k * P by double-and-add."""
    k %= curve.r
    if P is None or k == 0:
        return None
    p = curve.p
    acc = ID
    for bit in bin(k)[2:]:
        acc = xyzz_dbl(p, acc)
        if bit == "1":
            acc = xyzz_madd(p, acc, P[0], P[1])
    return xyzz_to_affine(p, acc)


def combine(curve: Curve, terms) -> Point:
    """sum k_i * P_i over (k_i, P_i) pairs, one multiplication each."""
    acc = None
    for k, P in terms:
        acc = add(curve, acc, mul(curve, P, k))
    return acc
