"""Curve specs and exact host-side point arithmetic.

All six Nova curves have a = 0 (y^2 = x^3 + b), which the reference's MSM
exploits for its XYZZ formulas (src/provider/msm.rs:27-44); we rely on the
same fact in the device kernels.

Curve parameters:
- Pallas:    b = 5,  base = P_PALLAS, scalar = Q_PALLAS, gen = (-1, 2)
- Vesta:     b = 5,  swapped fields,                    gen = (-1, 2)
- BN254 G1:  b = 3,  gen = (1, 2)
- Grumpkin:  b = -17, gen = (1, sqrt(-16))
- secp256k1: b = 7,  standard SEC generator
- secq256k1: b = 7,  gen with x = 1 (cycle partner of secp)

Generator choices follow halo2curves' constants where they are standard
(pasta (-1,2); BN254 (1,2); secp SEC-G). The exact generator only matters
for in-library uses (tests, EC gadget vectors); commitments use hashed
generators from `from_label`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from nova_tpu_torch.fields.spec import (
    FieldSpec,
    pallas_base,
    pallas_scalar,
    bn254_base,
    bn254_scalar,
    secp_base,
    secp_scalar,
)


@dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec  # coordinates live here
    scalar: FieldSpec  # group order
    b: int
    gen_x: int
    gen_y: int

    def __post_init__(self):
        # sanity: generator on curve
        f = self.base
        lhs = f.mul(self.gen_y, self.gen_y)
        rhs = f.add(f.mul(f.mul(self.gen_x, self.gen_x), self.gen_x), self.b % f.p)
        assert lhs == rhs, f"{self.name}: generator not on curve"


class AffinePoint:
    """Host affine point; (0, 0, infinity=True) is the identity, matching the
    reference's to_coordinates convention (src/provider/traits.rs:303-312)."""

    __slots__ = ("curve", "x", "y", "infinity")

    def __init__(self, curve: CurveSpec, x: int = 0, y: int = 0, infinity: bool = False):
        self.curve = curve
        self.x = x
        self.y = y
        self.infinity = infinity

    # --- constructors ---

    @staticmethod
    def identity(curve: CurveSpec) -> "AffinePoint":
        return AffinePoint(curve, 0, 0, True)

    @staticmethod
    def generator(curve: CurveSpec) -> "AffinePoint":
        return AffinePoint(curve, curve.gen_x, curve.gen_y)

    @staticmethod
    def from_xy(curve: CurveSpec, x: int, y: int) -> Optional["AffinePoint"]:
        f = curve.base
        if x == 0 and y == 0:
            return AffinePoint.identity(curve)
        if f.mul(y, y) == f.add(f.mul(f.mul(x, x), x), curve.b % f.p):
            return AffinePoint(curve, x, y)
        return None

    # --- predicates ---

    def is_identity(self) -> bool:
        return self.infinity

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        f = self.curve.base
        return f.mul(self.y, self.y) == f.add(
            f.mul(f.mul(self.x, self.x), self.x), self.curve.b % f.p
        )

    def __eq__(self, other):
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.curve.name, self.x, self.y, self.infinity))

    def __repr__(self):
        if self.infinity:
            return f"<{self.curve.name} identity>"
        return f"<{self.curve.name} ({hex(self.x)}, {hex(self.y)})>"

    # --- group law (complete, a = 0) ---

    def neg(self) -> "AffinePoint":
        if self.infinity:
            return self
        return AffinePoint(self.curve, self.x, self.curve.base.neg(self.y))

    def double(self) -> "AffinePoint":
        if self.infinity:
            return self
        f = self.curve.base
        if self.y == 0:
            return AffinePoint.identity(self.curve)
        # lambda = 3x^2 / 2y  (a = 0)
        num = f.mul(3, f.mul(self.x, self.x))
        lam = f.mul(num, f.inv(f.add(self.y, self.y)))
        x3 = f.sub(f.mul(lam, lam), f.add(self.x, self.x))
        y3 = f.sub(f.mul(lam, f.sub(self.x, x3)), self.y)
        return AffinePoint(self.curve, x3, y3)

    def add(self, other: "AffinePoint") -> "AffinePoint":
        if self.infinity:
            return other
        if other.infinity:
            return self
        f = self.curve.base
        if self.x == other.x:
            if self.y == other.y:
                return self.double()
            return AffinePoint.identity(self.curve)
        lam = f.mul(f.sub(other.y, self.y), f.inv(f.sub(other.x, self.x)))
        x3 = f.sub(f.sub(f.mul(lam, lam), self.x), other.x)
        y3 = f.sub(f.mul(lam, f.sub(self.x, x3)), self.y)
        return AffinePoint(self.curve, x3, y3)

    def sub(self, other: "AffinePoint") -> "AffinePoint":
        return self.add(other.neg())

    def mul(self, k: int) -> "AffinePoint":
        """Scalar multiplication via Jacobian double-and-add (one field
        inversion total, not one per add)."""
        k %= self.curve.scalar.p
        if k == 0 or self.infinity:
            return AffinePoint.identity(self.curve)
        f = self.curve.base
        p = f.p
        # Jacobian accumulator (X, Y, Z); None = identity
        acc = None
        ax, ay = self.x, self.y
        for bit in bin(k)[2:]:
            if acc is not None:
                X, Y, Z = acc
                # dbl-2009-l (a = 0)
                A = X * X % p
                B = Y * Y % p
                C = B * B % p
                D = 2 * ((X + B) * (X + B) - A - C) % p
                E = 3 * A % p
                F = E * E % p
                X3 = (F - 2 * D) % p
                Y3 = (E * (D - X3) - 8 * C) % p
                Z3 = 2 * Y * Z % p
                acc = (X3, Y3, Z3) if Z3 else None
            if bit == "1":
                if acc is None:
                    acc = (ax, ay, 1)
                else:
                    X1, Y1, Z1 = acc
                    # madd-2007-bl (mixed add, Z2 = 1)
                    Z1Z1 = Z1 * Z1 % p
                    U2 = ax * Z1Z1 % p
                    S2 = ay * Z1 % p * Z1Z1 % p
                    if U2 == X1:
                        if S2 != Y1:
                            acc = None
                            continue
                        # doubling case
                        X, Y, Z = acc
                        A = X * X % p
                        B = Y * Y % p
                        C = B * B % p
                        D = 2 * ((X + B) * (X + B) - A - C) % p
                        E = 3 * A % p
                        F = E * E % p
                        X3 = (F - 2 * D) % p
                        Y3 = (E * (D - X3) - 8 * C) % p
                        Z3 = 2 * Y * Z % p
                        acc = (X3, Y3, Z3) if Z3 else None
                        continue
                    H = (U2 - X1) % p
                    HH = H * H % p
                    I = 4 * HH % p
                    J = H * I % p
                    r = 2 * (S2 - Y1) % p
                    V = X1 * I % p
                    X3 = (r * r - J - 2 * V) % p
                    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
                    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
                    acc = (X3, Y3, Z3) if Z3 else None
        if acc is None:
            return AffinePoint.identity(self.curve)
        X, Y, Z = acc
        zinv = f.inv(Z)
        zinv2 = zinv * zinv % p
        return AffinePoint(self.curve, X * zinv2 % p, Y * zinv2 % p * zinv % p)

    # --- serialization ---

    def to_coordinates(self):
        return (self.x, self.y, self.infinity)

    def to_transcript_bytes(self) -> bytes:
        """Commitment transcript repr (src/provider/pedersen.rs:103-118):
        x || y || infinity_byte with coordinates as 32-byte LE."""
        f = self.curve.base
        x, y = (0, 0) if self.infinity else (self.x, self.y)
        return f.to_repr(x) + f.to_repr(y) + bytes([1 if self.infinity else 0])


def _grumpkin_gen_y() -> int:
    # y^2 = 1 - 17 = -16 over bn254_scalar (grumpkin's base field);
    # halo2curves pins y = sqrt(-16) with the smaller root selected here
    # deterministically for reproducibility.
    f = bn254_scalar
    y = f.sqrt(f.p - 16)
    assert y is not None
    return min(y, f.p - y)


pallas = CurveSpec(
    "pallas", pallas_base, pallas_scalar, 5, pallas_base.p - 1, 2
)
vesta = CurveSpec(
    "vesta", pallas_scalar, pallas_base, 5, pallas_scalar.p - 1, 2
)
bn254 = CurveSpec("bn254", bn254_base, bn254_scalar, 3, 1, 2)
grumpkin = CurveSpec(
    "grumpkin", bn254_scalar, bn254_base, -17, 1, _grumpkin_gen_y()
)
secp256k1 = CurveSpec(
    "secp256k1",
    secp_base,
    secp_scalar,
    7,
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _secq_gen():
    # secq256k1: y^2 = x^3 + 7 over secp's scalar field; deterministic
    # smallest-x generator (cofactor 1).
    f = secp_scalar
    x = 1
    while True:
        rhs = f.add(f.mul(f.mul(x, x), x), 7)
        y = f.sqrt(rhs)
        if y is not None:
            return x, min(y, f.p - y)
        x += 1


_sx, _sy = _secq_gen()
secq256k1 = CurveSpec("secq256k1", secp_scalar, secp_base, 7, _sx, _sy)

ALL_CURVES = {
    c.name: c for c in [pallas, vesta, bn254, grumpkin, secp256k1, secq256k1]
}
