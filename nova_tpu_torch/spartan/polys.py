"""Polynomial library for the Spartan layer (port of
``nova_tpu/spartan/polys.py``; reference: src/spartan/polys/).

Multilinear polynomials are dense evaluation tables over {0,1}^n, held as
Python ints or as (n, 4) uint64 limbs for the native round kernels; the
bind and the eq-table build run in the native binding when it is available
(``nova_tpu_torch.native``), in pure Python otherwise.
"""

from __future__ import annotations

from typing import List, Sequence

from nova_tpu_torch import native
from nova_tpu_torch.errors import InvalidInputLengthError
from nova_tpu_torch.fields.spec import FieldSpec


def log2_int(n: int) -> int:
    """log_2 of a power of two (src/spartan/math.rs)."""
    assert n > 0 and (n & (n - 1)) == 0, n
    return n.bit_length() - 1


class MultilinearPolynomial:
    """Dense multilinear polynomial in evaluation form over {0,1}^num_vars
    (src/spartan/polys/multilinear.rs)."""

    __slots__ = ("field", "_Z", "_L", "num_vars")

    def __init__(self, field: FieldSpec, Z: Sequence[int]):
        from nova_tpu_torch.ops.fvec import HVec

        n = len(Z)
        assert n > 0 and (n & (n - 1)) == 0, n
        self.field = field
        if isinstance(Z, HVec):
            self._Z = None
            self._L = Z.limbs64()
        else:
            self._Z = list(Z)
            self._L = None
        self.num_vars = log2_int(n)

    # The evaluation table is dual-representation: Python ints (`Z`) for
    # generic code, (n, 4) uint64 limbs (`to_limbs`) for the native round
    # kernels. Whichever side binds/writes invalidates the other.
    @property
    def Z(self):
        if self._Z is None:
            self._Z = native.limbs_to_ints(self._L)
        return self._Z

    @Z.setter
    def Z(self, v):
        self._Z = list(v)
        self._L = None

    def to_limbs(self):
        if self._L is None:
            p = self.field.p
            self._L = native.ints_to_limbs([x % p for x in self._Z])
        return self._L

    def __len__(self):
        return 1 << self.num_vars

    def __getitem__(self, i):
        return self.Z[i]

    def bind_poly_var_top(self, r: int):
        """Bind the top (most significant) variable to r:
        Z'[i] = Z[i] + r*(Z[len/2 + i] - Z[i])."""
        if self._L is not None and native.available():
            self._L = native.vec_bind_l(self.field.p, self._L, r)
            self._Z = None
            self.num_vars -= 1
            return
        p = self.field.p
        Z = self.Z
        half = len(Z) // 2
        self.Z = [(a + r * (b - a)) % p for a, b in zip(Z[:half], Z[half:])]
        self.num_vars -= 1

    def evaluate(self, point: Sequence[int]) -> int:
        """Evaluate at point (top variable first, the order of
        bind_poly_var_top)."""
        assert len(point) == self.num_vars
        return MultilinearPolynomial.evaluate_with(self.field, self.Z, point)

    @staticmethod
    def evaluate_with(field: FieldSpec, Z: Sequence[int], point: Sequence[int]) -> int:
        chis = EqPolynomial.evals_from_points(field, point)
        assert len(chis) == len(Z)
        return sum(c * z for c, z in zip(chis, Z)) % field.p


class SparsePolynomial:
    """Multilinear extension of a short dense prefix (zero elsewhere); used
    for the public-IO part of Z (src/spartan/polys/multilinear.rs:190-225).
    Values sit at indices 0..len(Z)-1 of a 2^num_vars table (MSB-first)."""

    def __init__(self, field: FieldSpec, num_vars: int, Z: Sequence[int]):
        self.field = field
        self.num_vars = num_vars
        self.Z = list(Z)

    def evaluate(self, r: Sequence[int]) -> int:
        assert len(r) == self.num_vars
        p = self.field.p
        acc = 0
        for idx, val in enumerate(self.Z):
            chi = 1
            for i in range(self.num_vars):
                bit = (idx >> (self.num_vars - 1 - i)) & 1
                chi = chi * (r[i] if bit else (1 - r[i])) % p
            acc = (acc + chi * val) % p
        return acc


class EqPolynomial:
    """eq(r, x) = prod_i (r_i x_i + (1-r_i)(1-x_i))
    (src/spartan/polys/eq.rs)."""

    def __init__(self, field: FieldSpec, r: Sequence[int]):
        self.field = field
        self.r = list(r)

    def evaluate(self, rx: Sequence[int]) -> int:
        assert len(rx) == len(self.r)
        p = self.field.p
        acc = 1
        for a, b in zip(self.r, rx):
            acc = acc * ((a * b + (1 - a) * (1 - b)) % p) % p
        return acc

    @staticmethod
    def evals_from_points(field: FieldSpec, r: Sequence[int]) -> List[int]:
        """Full 2^n table by doubling; r[0] ends up as the MSB of the index,
        the ordering of the reference's rev() build."""
        p = field.p
        if native.available() and len(r) >= 8:
            return native.limbs_to_ints(native.eq_evals_l(p, list(r)))
        evals = [1]
        for ri in r:
            nxt = []
            for e in evals:
                hi = e * ri % p
                nxt.append((e - hi) % p)
                nxt.append(hi)
            evals = nxt
        return evals

    @staticmethod
    def evals_hvec(field: FieldSpec, r: Sequence[int]):
        """Full table as an HVec (limbs-direct when native is available)."""
        if native.available() and len(r) >= 8:
            from nova_tpu_torch.ops.fvec import HVec

            return HVec(field.p,
                        limbs=native.eq_evals_l(field.p, [x % field.p for x in r]))
        return EqPolynomial.evals_from_points(field, list(r))

    def evals(self) -> List[int]:
        return EqPolynomial.evals_from_points(self.field, self.r)


class MaskedEqPolynomial:
    """eq(r, x) with the first 2^num_masked_vars entries zeroed
    (src/spartan/polys/masked_eq.rs); ppsnark's WitnessBoundSumcheck."""

    def __init__(self, eq: EqPolynomial, num_masked_vars: int):
        self.eq = eq
        self.num_masked_vars = num_masked_vars

    def evaluate(self, rx: Sequence[int]) -> int:
        """(eq_lo - mask_lo) * eq_hi with the split at n - m
        (src/spartan/polys/masked_eq.rs:34-53)."""
        field = self.eq.field
        p = field.p
        r = self.eq.r
        assert len(rx) == len(r)
        split = len(r) - self.num_masked_vars
        eq_lo = EqPolynomial(field, r[:split]).evaluate(rx[:split])
        eq_hi = EqPolynomial(field, r[split:]).evaluate(rx[split:])
        mask_lo = 1
        for a, b in zip(r[:split], rx[:split]):
            mask_lo = mask_lo * ((1 - a) * (1 - b) % p) % p
        return (eq_lo - mask_lo) * eq_hi % p

    def evals(self) -> List[int]:
        """The eq table with the first 2^m entries zeroed
        (masked_eq.rs:57-76)."""
        tab = EqPolynomial.evals_from_points(self.eq.field, self.eq.r)
        for i in range(1 << self.num_masked_vars):
            tab[i] = 0
        return tab


class PowPolynomial:
    """pow(t, x) = t^{sum_i x_i 2^i}: the tensor (1, t, t^2, ...)
    (src/spartan/polys/power.rs)."""

    def __init__(self, field: FieldSpec, t: int, ell: int):
        self.field = field
        self.t = t % field.p
        self.ell = ell

    def coordinates(self) -> List[int]:
        """[t^{2^0}, t^{2^1}, ..., t^{2^{ell-1}}]."""
        p = self.field.p
        out = []
        cur = self.t
        for _ in range(self.ell):
            out.append(cur)
            cur = cur * cur % p
        return out

    def evals(self) -> List[int]:
        """(1, t, t^2, ..., t^{2^ell - 1})."""
        p = self.field.p
        out = [1] * (1 << self.ell)
        for i in range(1, len(out)):
            out[i] = out[i - 1] * self.t % p
        return out

    def evaluate(self, rx: Sequence[int]) -> int:
        p = self.field.p
        acc = 1
        for coord, x in zip(self.coordinates(), rx):
            acc = acc * ((x * coord + (1 - x)) % p) % p
        return acc

    def split_evals(self, len_left: int, len_right: int) -> List[int]:
        """Two tensor factors whose outer product equals evals()
        (src/spartan/polys/power.rs:62-90): left ++ right."""
        p = self.field.p
        assert len_left * len_right == 1 << self.ell
        left = [1] * len_left
        for i in range(1, len_left):
            left[i] = left[i - 1] * self.t % p
        step = left[-1] * self.t % p
        right = [1] * len_right
        for i in range(1, len_right):
            right[i] = right[i - 1] * step % p
        return left + right


class IdentityPolynomial:
    """The multilinear polynomial that maps x in {0,1}^ell to its integer
    value (src/spartan/polys/identity.rs)."""

    def __init__(self, field: FieldSpec, ell: int):
        self.field = field
        self.ell = ell

    def evaluate(self, r: Sequence[int]) -> int:
        assert len(r) == self.ell
        p = self.field.p
        acc = 0
        for i, ri in enumerate(r):
            acc = (acc + (1 << (self.ell - 1 - i)) * ri) % p
        return acc


# ---------------------------------------------------------------------------
# univariate round polynomials
# ---------------------------------------------------------------------------

def gaussian_elimination(field: FieldSpec, matrix: List[List[int]]) -> List[int]:
    """Solve the augmented system (src/spartan/polys/univariate.rs:218)."""
    p = field.p
    size = len(matrix)
    for i in range(size - 1):
        # partial pivot
        piv = max(range(i, size), key=lambda r: 1 if matrix[r][i] % p != 0 else 0)
        if matrix[piv][i] % p == 0:
            raise ZeroDivisionError("singular matrix")
        matrix[i], matrix[piv] = matrix[piv], matrix[i]
        inv = field.inv(matrix[i][i] % p)
        for r in range(i + 1, size):
            factor = matrix[r][i] * inv % p
            for c in range(i, size + 1):
                matrix[r][c] = (matrix[r][c] - factor * matrix[i][c]) % p
    result = [0] * size
    for i in range(size - 1, -1, -1):
        acc = matrix[i][size]
        for c in range(i + 1, size):
            acc = (acc - matrix[i][c] * result[c]) % p
        result[i] = acc * field.inv(matrix[i][i] % p) % p
    return result


class UniPoly:
    """Univariate polynomial, little-endian coefficients
    (src/spartan/polys/univariate.rs:20)."""

    __slots__ = ("field", "coeffs")

    def __init__(self, field: FieldSpec, coeffs: Sequence[int]):
        self.field = field
        self.coeffs = [c % field.p for c in coeffs]

    @staticmethod
    def from_coeffs(field: FieldSpec, coeffs: Sequence[int]) -> "UniPoly":
        if len(coeffs) == 0:
            raise InvalidInputLengthError()
        coeffs = [c % field.p for c in coeffs]
        while len(coeffs) > 1 and coeffs[-1] == 0:
            coeffs.pop()
        return UniPoly(field, coeffs)

    @staticmethod
    def from_evals(field: FieldSpec, evals: Sequence[int]) -> "UniPoly":
        """Interpolate from P(0), P(1), ..., P(n-1)."""
        n = len(evals)
        if n == 1:
            return UniPoly(field, [evals[0]])
        p = field.p
        matrix = []
        for i in range(n):
            row = [1]
            for _ in range(1, n):
                row.append(row[-1] * i % p)
            row.append(evals[i] % p)
            matrix.append(row)
        return UniPoly(field, gaussian_elimination(field, matrix))

    @staticmethod
    def from_evals_deg2(field: FieldSpec, evals: Sequence[int]) -> "UniPoly":
        """[P(0), P(1), quad_coeff a] -> a x^2 + b x + c."""
        p = field.p
        c = evals[0] % p
        a = evals[2] % p
        b = (evals[1] - a - c) % p
        return UniPoly(field, [c, b, a])

    @staticmethod
    def from_evals_deg3(field: FieldSpec, evals: Sequence[int]) -> "UniPoly":
        """[P(0), P(1), cubic_coeff a, P(-1)] -> a x^3 + b x^2 + c x + d."""
        p = field.p
        d = evals[0] % p
        a = evals[2] % p
        b2_d2 = (evals[1] + evals[3]) % p
        b = (b2_d2 * field.inv(2) - d) % p
        c = (evals[1] - a - d - b) % p
        return UniPoly(field, [d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % self.field.p

    def evaluate(self, r: int) -> int:
        p = self.field.p
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % p
        return acc

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly(self.field, [self.coeffs[0]] + list(self.coeffs[2:]))

    def to_transcript_bytes(self) -> bytes:
        return b"".join(self.field.to_repr(c)
                        for c in [self.coeffs[0]] + list(self.coeffs[2:]))


class CompressedUniPoly:
    """UniPoly minus its linear term, recoverable from the round claim
    (src/spartan/polys/univariate.rs:30,161)."""

    __slots__ = ("field", "coeffs_except_linear_term")

    def __init__(self, field: FieldSpec, coeffs_except_linear_term: Sequence[int]):
        self.field = field
        self.coeffs_except_linear_term = [c % field.p for c in coeffs_except_linear_term]

    def decompress(self, hint: int) -> UniPoly:
        """linear term = hint - 2*c0 - sum(other coeffs) (P(0)+P(1)=hint)."""
        p = self.field.p
        cs = self.coeffs_except_linear_term
        linear = (hint - 2 * cs[0] - sum(cs[1:])) % p
        return UniPoly(self.field, [cs[0], linear] + list(cs[1:]))
