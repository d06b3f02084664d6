"""BN254 (alt_bn128) optimal-ate pairing, host-side (copy of
``nova_tpu/curves/pairing.py``).

The reference gets pairings from halo2curves (`PairingGroup` at
src/provider/traits.rs:121-130, wired for BN256 at
src/provider/bn256_grumpkin.rs:88); they are verifier-side only (HyperKZG /
Mercury verification, 2-3 pairings per proof), so a scalar host
implementation is the right cost point — no device kernel needed.

Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 9+u;
Fp12 = Fp6[w]/(w^2 - v). Standard optimal ate: Miller loop over 6z+2
(z = 4965661367192848881) with NAF, two Frobenius line steps, final
exponentiation = easy part + plain square-and-multiply hard part.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from nova_tpu_torch.curves.spec import AffinePoint, bn254

P = bn254.base.p
BN_Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_Z + 2
CURVE_ORDER = bn254.scalar.p

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    # (a0^2 - a1^2, 2 a0 a1)
    t = (a[0] + a[1]) * (a[0] - a[1]) % P
    return (t, 2 * a[0] * a[1] % P)


def f2_muls(a, s):
    return (a[0] * s % P, a[1] * s % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1] * d) % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # 9 + u

# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - XI): elements (c0, c1, c2)
# ---------------------------------------------------------------------------

def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_muls2(a, s2):
    """multiply by an Fp2 scalar"""
    return tuple(f2_mul(x, s2) for x in a)


def f6_mul_v(a):
    """multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)"""
    return (_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)

# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v): elements (c0, c1)
# ---------------------------------------------------------------------------

def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    t = f6_sub(f6_sqr(a0), f6_mul_v(f6_sqr(a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


F12_ONE = (F6_ONE, F6_ZERO)

# Frobenius coefficients: gamma_1[j] = xi^((p-1)*j/6) for j=1..5
_FROB_GAMMA1: List[Tuple[int, int]] = []


def _init_frobenius():
    global _FROB_GAMMA1
    if _FROB_GAMMA1:
        return
    # xi^((p-1)/6): compute in Fp2 via exponentiation
    def f2_pow(a, e):
        r = F2_ONE
        b = a
        while e:
            if e & 1:
                r = f2_mul(r, b)
            b = f2_sqr(b)
            e >>= 1
        return r

    g = f2_pow(XI, (P - 1) // 6)
    cur = F2_ONE
    out = [F2_ONE]
    for _ in range(5):
        cur = f2_mul(cur, g)
        out.append(cur)
    _FROB_GAMMA1 = out


def f2_frob(a):
    """a^p in Fp2 = conjugate"""
    return f2_conj(a)


def f12_frob(a):
    """a^p in Fp12."""
    _init_frobenius()
    g = _FROB_GAMMA1
    (c00, c01, c02), (c10, c11, c12) = a
    r00 = f2_frob(c00)
    r01 = f2_mul(f2_frob(c01), g[2])
    r02 = f2_mul(f2_frob(c02), g[4])
    r10 = f2_mul(f2_frob(c10), g[1])
    r11 = f2_mul(f2_frob(c11), g[3])
    r12 = f2_mul(f2_frob(c12), g[5])
    return ((r00, r01, r02), (r10, r11, r12))


# ---------------------------------------------------------------------------
# G2 (points over Fp2, y^2 = x^3 + 3/xi), Jacobian-free affine ops (tiny use)
# ---------------------------------------------------------------------------

G2_B = f2_mul((3, 0), f2_inv(XI))

G2_GENERATOR = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


class G2Point:
    """Affine G2 point; None coords = identity."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x=None, y=None, inf=False):
        self.x = x
        self.y = y
        self.inf = inf or x is None

    @staticmethod
    def generator():
        return G2Point(G2_GENERATOR[0], G2_GENERATOR[1])

    @staticmethod
    def identity():
        return G2Point(inf=True)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        lhs = f2_sqr(self.y)
        rhs = f2_add(f2_mul(f2_sqr(self.x), self.x), G2_B)
        return lhs == rhs

    def neg(self):
        if self.inf:
            return self
        return G2Point(self.x, f2_neg(self.y))

    def add(self, other: "G2Point") -> "G2Point":
        if self.inf:
            return other
        if other.inf:
            return self
        if self.x == other.x:
            if self.y == other.y:
                return self.double()
            return G2Point.identity()
        lam = f2_mul(f2_sub(other.y, self.y), f2_inv(f2_sub(other.x, self.x)))
        x3 = f2_sub(f2_sub(f2_sqr(lam), self.x), other.x)
        y3 = f2_sub(f2_mul(lam, f2_sub(self.x, x3)), self.y)
        return G2Point(x3, y3)

    def double(self) -> "G2Point":
        if self.inf or self.y == F2_ZERO:
            return G2Point.identity()
        lam = f2_mul(f2_muls(f2_sqr(self.x), 3), f2_inv(f2_muls(self.y, 2)))
        x3 = f2_sub(f2_sqr(lam), f2_muls(self.x, 2))
        y3 = f2_sub(f2_mul(lam, f2_sub(self.x, x3)), self.y)
        return G2Point(x3, y3)

    def mul(self, k: int) -> "G2Point":
        k %= CURVE_ORDER
        acc = G2Point.identity()
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.double()
            k >>= 1
        return acc

    def frobenius(self) -> "G2Point":
        """psi(x,y) = (x^p * gamma12, y^p * gamma13) — the untwist-Frobenius-
        twist endomorphism."""
        _init_frobenius()
        g = _FROB_GAMMA1

        def f2_pow(a, e):
            r = F2_ONE
            b = a
            while e:
                if e & 1:
                    r = f2_mul(r, b)
                b = f2_sqr(b)
                e >>= 1
            return r

        gamma12 = f2_pow(XI, (P - 1) // 3)
        gamma13 = f2_pow(XI, (P - 1) // 2)
        return G2Point(
            f2_mul(f2_conj(self.x), gamma12),
            f2_mul(f2_conj(self.y), gamma13),
        )

    def __eq__(self, other):
        if self.inf or other.inf:
            return self.inf and other.inf
        return self.x == other.x and self.y == other.y


# ---------------------------------------------------------------------------
# Miller loop (lines evaluated at a G1 point)
# ---------------------------------------------------------------------------

def _line_double(Q: G2Point, Pt) -> Tuple:
    """Line through Q,Q evaluated at P=(px,py); returns (f12 line, 2Q)."""
    px, py = Pt
    lam = f2_mul(f2_muls(f2_sqr(Q.x), 3), f2_inv(f2_muls(Q.y, 2)))
    R = Q.double()
    # l(P) = lam * px - py + (y_Q - lam x_Q) as element of Fp12:
    # standard sparse embedding: l = (py) * w^0 ... use the D-twist layout:
    # l = -py + lam*px*w^? — use explicit embedding below.
    return _embed_line(lam, Q, px, py), R


def _line_add(Q: G2Point, S: G2Point, Pt) -> Tuple:
    px, py = Pt
    lam = f2_mul(f2_sub(S.y, Q.y), f2_inv(f2_sub(S.x, Q.x)))
    R = Q.add(S)
    return _embed_line(lam, Q, px, py), R


def _embed_line(lam, Q: G2Point, px, py):
    """Line y - y_Q = lam (x - x_Q) through the UNTWISTED Q, evaluated at
    the G1 point (px, py), as an Fp12 element.

    With Fp12 = Fp6[w] (w^2 = v, w^6 = xi) and the D-twist
    E': y'^2 = x'^3 + 3/xi, the untwist map is
        (x', y') -> (x'*w^2, y'*w^3)
    (check: (y' w^3)^2 = (x'^3 + 3/xi)*xi = (x' w^2)^3 + 3 since w^6 = xi).
    The untwisted slope is d(y' w^3)/d(x' w^2) = lam * w.

    Constructed with generic Fp12 arithmetic (a few muls per step) —
    verifier-side only, so clarity over sparse-multiplication tricks.
    """
    X = _f12_from_fp(px)
    Y = _f12_from_fp(py)
    xQu = f12_mul(_f12_from_f2(Q.x), _W2)
    yQu = f12_mul(_f12_from_f2(Q.y), _W3)
    lamu = f12_mul(_f12_from_f2(lam), _W)
    l = _f12_sub(_f12_sub(Y, yQu), f12_mul(lamu, _f12_sub(X, xQu)))
    return l


def _f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def _f12_from_fp(x: int):
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _f12_from_f2(x):
    return ((x, F2_ZERO, F2_ZERO), F6_ZERO)


# w powers: w = (0, 1) in Fp6[w] => w^2 = v, w^3 = v*w
_W = (F6_ZERO, F6_ONE)
_W2 = ((F2_ZERO, F2_ONE, F2_ZERO), F6_ZERO)           # v
_W3 = (F6_ZERO, (F2_ZERO, F2_ONE, F2_ZERO))           # v*w


def miller_loop(Q: G2Point, Pt: AffinePoint, final_exp: bool = True):
    """Optimal ate Miller loop e(P, Q)-style value (P in G1, Q in G2)."""
    if Q.inf or Pt.infinity:
        return F12_ONE
    Ppair = (Pt.x % P, Pt.y % P)
    R = Q
    f = F12_ONE
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        l, R = _line_double(R, Ppair)
        f = f12_mul(f12_sqr(f), l)
        if bit == "1":
            l, R = _line_add(R, Q, Ppair)
            f = f12_mul(f, l)
    # two Frobenius line steps
    Q1 = Q.frobenius()
    Q2 = Q1.frobenius().neg()
    l, R = _line_add(R, Q1, Ppair)
    f = f12_mul(f, l)
    l, R = _line_add(R, Q2, Ppair)
    f = f12_mul(f, l)
    if final_exp:
        return final_exponentiation(f)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part then plain pow for the hard part."""
    # easy part: f^(p^6-1) = conj(f)/f ; then ^(p^2+1)
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f2 = f12_mul(f12_frob(f12_frob(f1)), f1)
    # hard part: exponent (p^4 - p^2 + 1)/r
    e = (P ** 4 - P ** 2 + 1) // CURVE_ORDER
    return f12_pow(f2, e)


def pairing(Pt: AffinePoint, Q: G2Point):
    """e: G1 x G2 -> GT."""
    assert Pt.curve is bn254 or Pt.curve.name == "bn254"
    return miller_loop(Q, Pt)


def multi_pairing_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (shared final exponentiation)."""
    acc = F12_ONE
    for Pt, Q in pairs:
        acc = f12_mul(acc, miller_loop(Q, Pt, final_exp=False))
    return final_exponentiation(acc) == F12_ONE
