"""Field specifications and exact host-side arithmetic.

Moduli are taken from the curve parameter strings the reference pins in its
`impl_traits!` invocations (src/provider/pasta.rs:33-47,
src/provider/bn256_grumpkin.rs:35-86, src/provider/secp_secq.rs:38-52);
each curve's scalar-field modulus is its cycle partner's base-field modulus.

Field elements at the host level are plain Python ints in [0, p). The
canonical byte representation matches `ff`'s `to_repr` for these fields:
32 bytes little-endian.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

# Number of 16-bit limbs in the device representation.
NUM_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """A prime field F_p with helpers for both host and device engines."""

    name: str
    p: int

    # --- derived (computed in __post_init__) ---
    num_bits: int = field(init=False)
    r: int = field(init=False)  # Montgomery radix 2^256 mod p
    r2: int = field(init=False)  # (2^256)^2 mod p
    r3: int = field(init=False)
    n0inv: int = field(init=False)  # -p^{-1} mod 2^LIMB_BITS
    p_limbs: tuple = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "num_bits", self.p.bit_length())
        R = 1 << (NUM_LIMBS * LIMB_BITS)
        object.__setattr__(self, "r", R % self.p)
        object.__setattr__(self, "r2", (R * R) % self.p)
        object.__setattr__(self, "r3", (R * R % self.p) * R % self.p)
        pinv = pow(self.p, -1, 1 << LIMB_BITS)
        object.__setattr__(self, "n0inv", ((1 << LIMB_BITS) - pinv) % (1 << LIMB_BITS))
        object.__setattr__(self, "p_limbs", tuple(to_limbs(self.p)))

    # ---- host arithmetic (exact) ----

    def add(self, a: int, b: int) -> int:
        s = a + b
        return s - self.p if s >= self.p else s

    def sub(self, a: int, b: int) -> int:
        d = a - b
        return d + self.p if d < 0 else d

    def neg(self, a: int) -> int:
        return (self.p - a) % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def square(self, a: int) -> int:
        return a * a % self.p

    def double(self, a: int) -> int:
        return self.add(a, a)

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def sqrt(self, a: int):
        """Tonelli-Shanks; returns a square root or None."""
        p = self.p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r_ = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r_ = r_ * b % p
        return r_

    def batch_inv(self, xs):
        """Montgomery batch inversion on the host (zeros map to zero,
        matching the reference's batch_invert contract in
        src/spartan/mod.rs:54-117 which requires nonzero inputs; we tolerate
        zeros for robustness in tests)."""
        n = len(xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % self.p
        inv_all = self.inv(prefix[n])
        out = [0] * n
        for i in range(n - 1, -1, -1):
            x = xs[i]
            if x == 0:
                out[i] = 0
            else:
                out[i] = prefix[i] * inv_all % self.p
                inv_all = inv_all * x % self.p
        return out

    # ---- representations ----

    def to_repr(self, a: int) -> bytes:
        """Canonical little-endian 32-byte representation (ff::to_repr)."""
        return int(a).to_bytes(32, "little")

    def from_repr(self, b: bytes):
        """Parse canonical LE bytes; None if >= p (ff::from_repr_vartime)."""
        v = int.from_bytes(b, "little")
        return v if v < self.p else None

    def from_uniform(self, b: bytes) -> int:
        """ff::FromUniformBytes for 64-byte inputs: LE integer mod p."""
        return int.from_bytes(b, "little") % self.p

    def from_u64(self, v: int) -> int:
        return v % self.p

    # ---- device representation helpers ----

    def to_mont(self, a: int) -> int:
        return a * self.r % self.p

    def from_mont(self, a: int) -> int:
        # multiply by R^{-1}
        return a * pow(self.r, -1, self.p) % self.p


def to_limbs(a: int, n: int = NUM_LIMBS) -> list:
    """Split an int into n 16-bit limbs, little-endian."""
    return [(a >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def from_limbs(limbs) -> int:
    out = 0
    for i, l in enumerate(limbs):
        out |= (int(l) & LIMB_MASK) << (LIMB_BITS * i)
    return out


# ---------------------------------------------------------------------------
# The six field moduli of the three curve cycles.
#
# Pallas:  y^2 = x^3 + 5 over Fp_pallas ; scalar field = Fq (= vesta base)
#   p = 0x40000000000000000000000000000000224698fc094cf91b992d30ed00000001
#   q = 0x40000000000000000000000000000000224698fc0994a8dd8c46eb2100000001
# (src/provider/pasta.rs:33-47: order/base strings for pallas are
#  order=q-string, base=p-string.)
# ---------------------------------------------------------------------------

P_PALLAS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q_PALLAS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

P_BN254 = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
Q_BN254 = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

P_SECP = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
Q_SECP = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# Pallas base field == Vesta scalar field and vice versa.
pallas_base = FieldSpec("pallas_base", P_PALLAS)
pallas_scalar = FieldSpec("pallas_scalar", Q_PALLAS)
vesta_base = pallas_scalar
vesta_scalar = pallas_base

# BN254 (bn256) G1: base Fq ("base" string), scalar Fr ("order" string).
# Grumpkin is the cycle partner: base = BN254 scalar, scalar = BN254 base.
bn254_base = FieldSpec("bn254_base", P_BN254)
bn254_scalar = FieldSpec("bn254_scalar", Q_BN254)
grumpkin_base = bn254_scalar
grumpkin_scalar = bn254_base

secp_base = FieldSpec("secp_base", P_SECP)
secp_scalar = FieldSpec("secp_scalar", Q_SECP)
secq_base = secp_scalar
secq_scalar = secp_base

ALL_FIELDS = {
    f.name: f
    for f in [
        pallas_base,
        pallas_scalar,
        bn254_base,
        bn254_scalar,
        secp_base,
        secp_scalar,
    ]
}


@functools.lru_cache(maxsize=None)
def field_by_modulus(p: int) -> FieldSpec:
    for f in ALL_FIELDS.values():
        if f.p == p:
            return f
    return FieldSpec(f"F_{p % 100000}", p)
