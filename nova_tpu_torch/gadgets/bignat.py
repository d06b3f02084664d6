"""Non-native (limbed) big-integer arithmetic in-circuit
(reference: src/gadgets/nonnative/bignat.rs + util.rs, a bellman-bignat
port). Used by the augmented circuit to fold public IO defined over the
*other* curve's field (64-bit limbs × 4, src/constants.rs:10-13).

Values are Python ints (naturals, can exceed the circuit field); limb
values are field elements; limbs are LinearCombinations. In tape mode
(frontend/tape.py) all derived naturals are epoch-memoized Lazy cells so
a recorded witness tape replays with fresh inputs."""

from __future__ import annotations

import math
from typing import List, Optional

from nova_tpu_torch.errors import AssignmentMissingError, SynthesisError
from nova_tpu_torch.frontend.boolean import AllocatedBit
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE
from nova_tpu_torch.frontend.num import AllocatedNum, Num
from nova_tpu_torch.frontend import tape as _tape
from nova_tpu_torch.frontend.tape import Lazy
from nova_tpu_torch.gadgets.utils import lc_of


def nat_to_limbs(nat: int, limb_width: int, n_limbs: int) -> List[int]:
    if nat.bit_length() > n_limbs * limb_width:
        raise SynthesisError(f"nat does not fit in {n_limbs} x {limb_width}")
    mask = (1 << limb_width) - 1
    return [(nat >> (i * limb_width)) & mask for i in range(n_limbs)]


def limbs_to_nat(limbs: List[int], limb_width: int) -> int:
    acc = 0
    for l in reversed(limbs):
        acc = (acc << limb_width) + l
    return acc


def _resolve(v):
    return v.get() if isinstance(v, Lazy) else v


# ---------------------------------------------------------------------------
# Num helpers (nonnative/util.rs)
# ---------------------------------------------------------------------------

def num_fits_in_bits(cs: ConstraintSystem, num: Num, n_bits: int):
    """Range check (util.rs:97-155): allocate bits 1..n, booleanity for each,
    and a final quadratic constraint forcing num - sum(2^i b_i) in {0,1}."""
    bit_vars = []
    for i in range(1, n_bits):
        def bv(i=i):
            v = num.get_value()
            return None if v is None else (1 if (v >> i) & 1 else 0)

        bit_vars.append(cs.alloc(bv))
    for var in bit_vars:
        cs.enforce(
            lc_of(var),
            LinearCombination.from_variable(ONE) - var,
            LinearCombination.zero(),
        )
    # last bit: (num - sum) * (1 - num + sum) = 0
    lc_a = num.to_lc(1)
    f = 1
    for var in bit_vars:
        f <<= 1
        lc_a = lc_a - (f, var)
    lc_b = LinearCombination.from_variable(ONE).add_lc(num.to_lc(1), -1)
    f = 1
    for var in bit_vars:
        f <<= 1
        lc_b = lc_b + (f, var)
    cs.enforce(lc_a, lc_b, LinearCombination.zero())


def num_decompose(cs: ConstraintSystem, num: Num, n_bits: int):
    """Full bit decomposition with booleanity + sum check (util.rs:175-215).
    Returns list of AllocatedBit."""
    bits = []
    for i in range(n_bits):
        def bv(i=i):
            v = num.get_value()
            return None if v is None else bool((v >> i) & 1)

        bits.append(AllocatedBit.alloc(cs, bv))
    lc = num.to_lc(1)
    f = 1
    for b in bits:
        lc = lc - (f, b.get_variable())
        f <<= 1
    cs.enforce(lc, LinearCombination.from_variable(ONE), LinearCombination.zero())
    return bits


def num_is_equal_to_bits(cs: ConstraintSystem, num: Num, bits: List[AllocatedBit]):
    lc = num.to_lc(1)
    f = 1
    for b in bits:
        lc = lc - (f, b.get_variable())
        f <<= 1
    cs.enforce(lc, LinearCombination.from_variable(ONE), LinearCombination.zero())


# ---------------------------------------------------------------------------
# BigNat
# ---------------------------------------------------------------------------

class BigNat:
    __slots__ = ("limbs", "_limb_values", "_value", "limb_width", "n_limbs", "max_word", "min_bits")

    def __init__(self, limbs, limb_values, value, limb_width, n_limbs, max_word, min_bits=0):
        self.limbs = limbs  # List[LinearCombination]
        self._limb_values = limb_values  # Optional[List[int]] | Lazy (field elems)
        self._value = value  # Optional[int] | Lazy (natural)
        self.limb_width = limb_width
        self.n_limbs = n_limbs
        self.max_word = max_word
        self.min_bits = min_bits

    @property
    def limb_values(self):
        return _resolve(self._limb_values)

    @property
    def value(self):
        return _resolve(self._value)

    # --- allocation ---

    @staticmethod
    def alloc_from_nat(cs: ConstraintSystem, value, limb_width: int, n_limbs: int):
        """`value` may be an int/None (step-independent) or a closure/Lazy
        (re-read on tape replay)."""
        if callable(value) or isinstance(value, Lazy):
            vfn = value.get if isinstance(value, Lazy) else value
            val_l = Lazy(vfn)
            lvs_l = Lazy(
                lambda: None
                if val_l.get() is None
                else nat_to_limbs(val_l.get(), limb_width, n_limbs)
            )
            limbs = []
            for i in range(n_limbs):
                def lv(i=i):
                    ls = lvs_l.get()
                    return None if ls is None else ls[i]

                limbs.append(LinearCombination.from_variable(cs.alloc(lv)))
            return BigNat(
                limbs, lvs_l, val_l, limb_width, n_limbs, (1 << limb_width) - 1
            )
        if value is not None:
            lvs = nat_to_limbs(value, limb_width, n_limbs)
        else:
            lvs = None
        limbs = []
        for i in range(n_limbs):
            var = cs.alloc(None if lvs is None else lvs[i])
            limbs.append(LinearCombination.from_variable(var))
        return BigNat(
            limbs, lvs, value, limb_width, n_limbs, (1 << limb_width) - 1
        )

    @staticmethod
    def alloc_from_limbs(cs: ConstraintSystem, limb_values: Optional[List[int]],
                         limb_width: int, n_limbs: int, max_word: Optional[int] = None):
        limbs = []
        for i in range(n_limbs):
            var = cs.alloc(None if limb_values is None else limb_values[i])
            limbs.append(LinearCombination.from_variable(var))
        value = None if limb_values is None else limbs_to_nat(limb_values, limb_width)
        return BigNat(
            limbs, limb_values, value, limb_width, n_limbs,
            max_word if max_word is not None else (1 << limb_width) - 1,
        )

    @staticmethod
    def alloc_constant(cs: ConstraintSystem, value: int, limb_width: int, n_limbs: int):
        """alloc_bignat_constant (gadgets/utils.rs:116-139)."""
        lvs = nat_to_limbs(value, limb_width, n_limbs)
        bn = BigNat.alloc_from_limbs(cs, lvs, limb_width, n_limbs)
        for i in range(n_limbs):
            cs.enforce(
                bn.limbs[i].copy(),
                LinearCombination.from_variable(ONE),
                LinearCombination.zero() + (lvs[i], ONE),
            )
        return bn

    @staticmethod
    def from_num(cs: ConstraintSystem, n: Num, limb_width: int, n_limbs: int) -> "BigNat":
        """Allocate from an in-field number and bind via bit decomposition
        (bignat.rs:224-251)."""
        bn = BigNat.alloc_from_nat(cs, n.get_value if _tape.TRACING else n.get_value(),
                                   limb_width, n_limbs)
        bits = bn.decompose(cs)
        num_is_equal_to_bits(cs, n, bits)
        return bn

    # --- helpers ---

    def as_limbs(self) -> List[Num]:
        if _tape.TRACING:
            def lv(i):
                def fn():
                    ls = self.limb_values
                    return None if ls is None else ls[i]

                return Lazy(fn)

            return [Num(lv(i), self.limbs[i].copy()) for i in range(self.n_limbs)]
        return [
            Num(None if self.limb_values is None else self.limb_values[i], self.limbs[i].copy())
            for i in range(self.n_limbs)
        ]

    def assert_well_formed(self, cs: ConstraintSystem):
        for num in self.as_limbs():
            num_fits_in_bits(cs, num, self.limb_width)

    def decompose(self, cs: ConstraintSystem) -> List[AllocatedBit]:
        bits = []
        for num in self.as_limbs():
            bits.extend(num_decompose(cs, num, self.limb_width))
        return bits

    def n_bits(self) -> int:
        assert self.n_limbs > 0
        return self.limb_width * (self.n_limbs - 1) + self.max_word.bit_length()

    def group_limbs(self, limbs_per_group: int) -> "BigNat":
        n_groups = (self.n_limbs - 1) // limbs_per_group + 1
        limb_block = 1 << self.limb_width

        def compute_values():
            lvs = self.limb_values
            if lvs is None:
                return None
            new_values = [0] * n_groups
            shift = 1
            for i, v in enumerate(lvs):
                if i % limbs_per_group == 0:
                    shift = 1
                new_values[i // limbs_per_group] += shift * v
                shift *= limb_block
            return new_values

        new_values = Lazy(compute_values) if _tape.TRACING else compute_values()
        new_limbs = [LinearCombination.zero() for _ in range(n_groups)]
        shift = 1
        for i, limb in enumerate(self.limbs):
            if i % limbs_per_group == 0:
                shift = 1
            new_limbs[i // limbs_per_group].add_lc(limb, shift)
            shift *= limb_block
        max_word = 0
        for i in range(limbs_per_group):
            max_word |= 1 << (i * self.limb_width)
        max_word *= self.max_word
        return BigNat(
            new_limbs, new_values, self._value,
            self.limb_width * limbs_per_group, n_groups, max_word, self.min_bits,
        )

    # --- equality with carrying ---

    @staticmethod
    def _carry_bits(max_word: int, limb_width: int) -> int:
        # faithful to the f64 computation (bignat.rs:369-371)
        return int(math.ceil(math.log2(float(max_word) * 2.0) - limb_width) + 0.1)

    def equal_when_carried(self, cs: ConstraintSystem, other: "BigNat"):
        assert self.limb_width == other.limb_width
        n = min(len(self.limbs), len(other.limbs))
        target_base = 1 << self.limb_width
        accumulated_extra = 0
        max_word = max(self.max_word, other.max_word)
        carry_bits = self._carry_bits(max_word, self.limb_width)
        carry_in = Num(0, LinearCombination.zero())
        p = cs.field.p

        for i in range(n):
            def carry_val(i=i, carry_in=carry_in):
                slv, olv = self.limb_values, other.limb_values
                civ = carry_in.get_value()
                if slv is None or olv is None or civ is None:
                    return None
                return (slv[i] + civ + max_word - olv[i]) // target_base

            cf = Lazy(carry_val)

            def carry_mod(cf=cf):
                cv = cf.get()
                return None if cv is None else cv % p

            carry_var = cs.alloc(carry_mod if _tape.TRACING else carry_mod())
            carry = Num(cf if _tape.TRACING else cf.get(),
                        LinearCombination.from_variable(carry_var))
            accumulated_extra += max_word

            lc = carry_in.to_lc(1)
            lc.add_lc(self.limbs[i])
            lc.add_lc(other.limbs[i], -1)
            lc.add_term(max_word % p, ONE)
            lc.add_lc(carry.lc, -(target_base % p))
            lc.add_term(-((accumulated_extra % target_base) % p), ONE)
            cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc)

            accumulated_extra //= target_base

            if i < n - 1:
                num_fits_in_bits(cs, carry, carry_bits)
            else:
                lc2 = carry.to_lc(1)
                lc2.add_term(-(accumulated_extra % p), ONE)
                cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc2)
            carry_in = carry

        for limb in self.limbs[n:]:
            cs.enforce(LinearCombination.zero(), LinearCombination.zero(), limb.copy())
        for limb in other.limbs[n:]:
            cs.enforce(LinearCombination.zero(), LinearCombination.zero(), limb.copy())

    def equal_when_carried_regroup(self, cs: ConstraintSystem, other: "BigNat"):
        assert self.limb_width == other.limb_width
        max_word = max(self.max_word, other.max_word)
        carry_bits = self._carry_bits(max_word, self.limb_width)
        capacity = cs.field.num_bits - 1
        limbs_per_group = (capacity - carry_bits) // self.limb_width
        self_grouped = self.group_limbs(limbs_per_group)
        other_grouped = other.group_limbs(limbs_per_group)
        self_grouped.equal_when_carried(cs, other_grouped)

    # --- arithmetic ---

    def add(self, other: "BigNat") -> "BigNat":
        assert self.limb_width == other.limb_width
        n_limbs = max(self.n_limbs, other.n_limbs)
        max_word = self.max_word + other.max_word
        limbs = []
        for i in range(n_limbs):
            lc = LinearCombination.zero()
            if i < len(self.limbs):
                lc.add_lc(self.limbs[i])
            if i < len(other.limbs):
                lc.add_lc(other.limbs[i])
            limbs.append(lc)

        def compute_limb_values():
            slv, olv = self.limb_values, other.limb_values
            if slv is None or olv is None:
                return None
            return [
                (slv[i] if i < len(slv) else 0) + (olv[i] if i < len(olv) else 0)
                for i in range(n_limbs)
            ]

        def compute_value():
            sv, ov = self.value, other.value
            if sv is None or ov is None:
                return None
            return sv + ov

        if _tape.TRACING:
            limb_values, value = Lazy(compute_limb_values), Lazy(compute_value)
        else:
            limb_values, value = compute_limb_values(), compute_value()
        return BigNat(
            limbs, limb_values, value, self.limb_width, n_limbs, max_word,
            max(self.min_bits, other.min_bits),
        )

    def mult_mod(self, cs: ConstraintSystem, other: "BigNat", modulus: "BigNat"):
        """(quotient, remainder) with a*b = q*m + r enforced via polynomial
        identity + carried equality (bignat.rs:503-571)."""
        assert self.limb_width == other.limb_width
        limb_width = self.limb_width
        quotient_bits = max(0, self.n_bits() + other.n_bits() - modulus.min_bits)
        quotient_limbs = max(0, quotient_bits - 1) // limb_width + 1

        def compute_qr():
            sv, ov, mv = self.value, other.value, modulus.value
            if sv is None or ov is None or mv is None:
                return None
            return divmod(sv * ov, mv)

        qr = Lazy(compute_qr)

        def qv():
            v = qr.get()
            return None if v is None else v[0]

        def rv():
            v = qr.get()
            return None if v is None else v[1]

        if not _tape.TRACING:
            q0, r0 = (qr.get() or (None, None))
            quotient = BigNat.alloc_from_nat(cs, q0, limb_width, quotient_limbs)
            remainder = BigNat.alloc_from_nat(cs, r0, limb_width, modulus.n_limbs)
        else:
            quotient = BigNat.alloc_from_nat(cs, qv, limb_width, quotient_limbs)
            remainder = BigNat.alloc_from_nat(cs, rv, limb_width, modulus.n_limbs)
        quotient.assert_well_formed(cs)
        remainder.assert_well_formed(cs)

        left = _poly_alloc_product(cs, self, other)
        right_product = _poly_alloc_product(cs, quotient, modulus)
        right = _poly_sum(cs, right_product, remainder)

        left_max_word = min(len(self.limbs), len(other.limbs)) * self.max_word * other.max_word
        right_max_word = (
            min(len(quotient.limbs), len(modulus.limbs)) * quotient.max_word * modulus.max_word
            + remainder.max_word
        )
        left_int = BigNat(left[0], left[1], left[2], limb_width, len(left[0]), left_max_word)
        right_int = BigNat(right[0], right[1], right[2], limb_width, len(right[0]), right_max_word)
        left_int.equal_when_carried_regroup(cs, right_int)
        return quotient, remainder

    def red_mod(self, cs: ConstraintSystem, modulus: "BigNat") -> "BigNat":
        """self mod m (bignat.rs:574-616)."""
        assert self.limb_width == modulus.limb_width
        limb_width = self.limb_width
        quotient_bits = max(0, self.n_bits() - modulus.min_bits)
        quotient_limbs = max(0, quotient_bits - 1) // limb_width + 1

        def compute_qr():
            sv, mv = self.value, modulus.value
            if sv is None or mv is None:
                return None
            return divmod(sv, mv)

        qr = Lazy(compute_qr)

        def qv():
            v = qr.get()
            return None if v is None else v[0]

        def rv():
            v = qr.get()
            return None if v is None else v[1]

        if not _tape.TRACING:
            q0, r0 = (qr.get() or (None, None))
            quotient = BigNat.alloc_from_nat(cs, q0, limb_width, quotient_limbs)
            remainder = BigNat.alloc_from_nat(cs, r0, limb_width, modulus.n_limbs)
        else:
            quotient = BigNat.alloc_from_nat(cs, qv, limb_width, quotient_limbs)
            remainder = BigNat.alloc_from_nat(cs, rv, limb_width, modulus.n_limbs)
        quotient.assert_well_formed(cs)
        remainder.assert_well_formed(cs)

        right_product = _poly_alloc_product(cs, quotient, modulus)
        right = _poly_sum(cs, right_product, remainder)
        right_max_word = (
            min(len(quotient.limbs), len(modulus.limbs)) * quotient.max_word * modulus.max_word
            + remainder.max_word
        )
        right_int = BigNat(right[0], right[1], right[2], limb_width, len(right[0]), right_max_word)
        self.equal_when_carried_regroup(cs, right_int)
        return remainder

    def sub_mod(self, cs: ConstraintSystem, other: "BigNat", modulus: "BigNat") -> "BigNat":
        """self - other mod m (bignat.rs:782-806)."""

        def dv():
            sv, ov, mv = self.value, other.value, modulus.value
            if sv is None or ov is None or mv is None:
                return None
            return (sv + mv - ov) % mv

        diff = BigNat.alloc_from_nat(
            cs, dv if _tape.TRACING else dv(), self.limb_width, self.n_limbs
        )
        summed = other.add(diff).red_mod(cs, modulus)
        self.equal_when_carried_regroup(cs, summed)
        return diff

    def fold_bn(self, cs: ConstraintSystem, other: "BigNat", r: "BigNat", modulus: "BigNat") -> "BigNat":
        """self + r*other mod m (bignat.rs:685-697)."""
        _, r0 = r.mult_mod(cs, other, modulus)
        r_new = self.add(r0)
        return r_new.red_mod(cs, modulus)

    def decompose_allocated(self, cs: ConstraintSystem) -> List[AllocatedBit]:
        """Boolean decomposition, 1 packing constraint per limb
        (bignat.rs:724-779)."""
        out = []
        for i in range(self.n_limbs):
            bits = []
            for j in range(self.limb_width):
                def bv(i=i, j=j):
                    lvs = self.limb_values
                    return None if lvs is None else bool((lvs[i] >> j) & 1)

                bits.append(AllocatedBit.alloc(cs, bv))
            packed = LinearCombination.zero()
            coeff = 1
            for b in bits:
                packed.add_term(coeff, b.get_variable())
                coeff <<= 1
            cs.enforce(packed, LinearCombination.from_variable(ONE), self.limbs[i].copy())
            out.extend(bits)
        return out

    def inputize(self, cs: ConstraintSystem):
        for i, l in enumerate(self.limbs):
            def lv(i=i):
                lvs = self.limb_values
                return None if lvs is None else lvs[i]

            v = cs.alloc_input(lv)
            cs.enforce(
                LinearCombination.zero(),
                LinearCombination.zero(),
                LinearCombination.from_variable(v).add_lc(l, -1),
            )

    def as_allocated_nums(self, cs: ConstraintSystem) -> List[AllocatedNum]:
        """Materialize each limb as an AllocatedNum (for RO absorption)."""
        p = cs.field.p
        out = []
        for num in self.as_limbs():
            def val(num=num):
                v = num.get_value()
                return None if v is None else v % p

            a = AllocatedNum.alloc(cs, val)
            cs.enforce(
                LinearCombination.zero(),
                LinearCombination.zero(),
                LinearCombination.from_variable(a.get_variable()).add_lc(num.lc, -1),
            )
            out.append(a)
        return out


def conditionally_select_bignat(cs: ConstraintSystem, a: BigNat, b: BigNat, condition) -> "BigNat":
    """cond ? a : b (gadgets/utils.rs:230-261)."""
    assert len(a.limbs) == len(b.limbs)

    def val():
        cv = condition.get_value()
        if cv is None:
            return None
        return a.value if cv else b.value

    c = BigNat.alloc_from_nat(
        cs, val if _tape.TRACING else val(), a.limb_width, a.n_limbs
    )
    for i in range(len(c.limbs)):
        cs.enforce(
            a.limbs[i].copy().add_lc(b.limbs[i], -1),
            condition.lc(ONE, 1),
            c.limbs[i].copy().add_lc(b.limbs[i], -1),
        )
    return c


def _poly_alloc_product(cs: ConstraintSystem, a: BigNat, b: BigNat):
    """Polynomial product with pointwise-evaluation constraints
    (bignat.rs:819-882). Returns (limb LCs, limb values, value)."""
    p = cs.field.p
    n = len(a.limbs) + len(b.limbs) - 1

    def compute_values():
        alv, blv = a.limb_values, b.limb_values
        if alv is None or blv is None:
            return None
        values = [0] * n
        for i, av in enumerate(alv):
            for j, bv in enumerate(blv):
                values[i + j] = (values[i + j] + av * bv) % p
        return values

    def compute_value():
        av, bv = a.value, b.value
        if av is None or bv is None:
            return None
        return av * bv

    coeffs = []
    if _tape.TRACING:
        values = Lazy(compute_values)
        for i in range(n):
            def vi(i=i):
                vs = values.get()
                return None if vs is None else vs[i]

            coeffs.append(LinearCombination.from_variable(cs.alloc(vi)))
        value = Lazy(compute_value)
    else:
        values = compute_values()
        for i in range(n):
            var = cs.alloc(None if values is None else values[i])
            coeffs.append(LinearCombination.from_variable(var))
        value = compute_value()
    # pointwise checks at x = 1..n
    for xi in range(1, n + 1):
        def eval_lc(lcs):
            acc = LinearCombination.zero()
            mult = 1
            for c in lcs:
                acc.add_lc(c, mult % p)
                mult = mult * xi
            return acc

        cs.enforce(eval_lc(a.limbs), eval_lc(b.limbs), eval_lc(coeffs))
    return coeffs, values, value


def _poly_sum(cs: ConstraintSystem, prod, c: BigNat):
    """Sum of polynomial product output and a BigNat (coefficient-wise)."""
    coeffs_a, values_a, value_a = prod
    n = max(len(coeffs_a), len(c.limbs))
    coeffs = []
    for i in range(n):
        lc = LinearCombination.zero()
        if i < len(coeffs_a):
            lc.add_lc(coeffs_a[i])
        if i < len(c.limbs):
            lc.add_lc(c.limbs[i])
        coeffs.append(lc)

    def compute_values():
        va, clv = _resolve(values_a), c.limb_values
        if va is None or clv is None:
            return None
        return [
            (va[i] if i < len(va) else 0) + (clv[i] if i < len(clv) else 0)
            for i in range(n)
        ]

    def compute_value():
        va, cv = _resolve(value_a), c.value
        if va is None or cv is None:
            return None
        return va + cv

    if _tape.TRACING:
        return coeffs, Lazy(compute_values), Lazy(compute_value)
    return coeffs, compute_values(), compute_value()
