"""In-circuit elliptic curve arithmetic (reference: src/gadgets/ecc.rs).

AllocatedPoint = (x, y, is_infinity) over the circuit's field (the BASE
field of the curve whose points are being manipulated — i.e. the scalar
field of the cycle partner). All curves have a = 0.

scalar_mul uses the reference's split strategy (ecc.rs:496-582): the first
NUM_BITS-2 bits run with incomplete (cheap) addition on
AllocatedPointNonInfinity with an assumed-1 first bit whose slack is
removed afterwards; the remaining bits use the complete law."""

from __future__ import annotations

from typing import List, Optional, Tuple

from nova_tpu_torch.curves.spec import CurveSpec
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.gadgets.utils import (
    alloc_num_equals,
    alloc_zero,
    alloc_constant,
    conditionally_select,
    conditionally_select2,
    lc_of,
    select_num_or_one,
    select_num_or_zero,
    select_num_or_zero2,
    select_one_or_diff2,
    select_one_or_num2,
    select_zero_or_num2,
)


class AllocatedPoint:
    """A point of `curve` allocated in a circuit over curve.base."""

    __slots__ = ("curve", "x", "y", "is_infinity")

    def __init__(self, curve: CurveSpec, x: AllocatedNum, y: AllocatedNum, is_infinity: AllocatedNum):
        self.curve = curve
        self.x = x
        self.y = y
        self.is_infinity = is_infinity

    @staticmethod
    def alloc(cs: ConstraintSystem, curve: CurveSpec, coords):
        """`coords` is an (x, y, is_infinity) tuple, None, or a closure
        returning either (tape mode re-reads it on every replay)."""
        cfn = coords if callable(coords) else (lambda: coords)
        x = AllocatedNum.alloc(cs, lambda: (lambda c: 0 if c is None else c[0])(cfn()))
        y = AllocatedNum.alloc(cs, lambda: (lambda c: 0 if c is None else c[1])(cfn()))
        is_inf = AllocatedNum.alloc(
            cs, lambda: (lambda c: 1 if (c is None or c[2]) else 0)(cfn())
        )
        cs.enforce(
            lc_of(is_inf.get_variable()),
            lc_of(ONE) - is_inf.get_variable(),
            LinearCombination.zero(),
        )
        return AllocatedPoint(curve, x, y, is_inf)

    @staticmethod
    def alloc_shape(cs: ConstraintSystem, curve: CurveSpec):
        """Allocation in shape mode (values unknown)."""
        x = AllocatedNum.alloc(cs, None) if not cs.is_witness_generator() else None
        raise NotImplementedError

    def check_on_curve(self, cs: ConstraintSystem):
        """(1-is_infinity)·y² = (1-is_infinity)(x³ + Ax + B) (ecc.rs:66-109)."""
        f = cs.field
        A = 0  # a = 0 for all supported curves
        B = self.curve.b % f.p
        y_sq = self.y.square(cs)
        x_sq = self.x.square(cs)
        x_cu = self.x.mul(cs, x_sq)

        def rhs_val():
            if self.is_infinity.get_value() is None or x_cu.get_value() is None:
                return None
            if self.is_infinity.get_value() == 1:
                return 0
            return (x_cu.get_value() + A * self.x.get_value() + B) % f.p

        rhs = AllocatedNum.alloc(cs, rhs_val)
        cs.enforce(
            lc_of(x_cu.get_variable()) + (A, self.x.get_variable()) + (B, ONE),
            lc_of(ONE) - self.is_infinity.get_variable(),
            lc_of(rhs.get_variable()),
        )
        cs.enforce(
            lc_of(y_sq.get_variable()),
            lc_of(ONE) - self.is_infinity.get_variable(),
            lc_of(rhs.get_variable()),
        )

    @staticmethod
    def default(cs: ConstraintSystem, curve: CurveSpec) -> "AllocatedPoint":
        zero = alloc_zero(cs)
        one = AllocatedNum(ONE, 1)
        return AllocatedPoint(curve, zero, zero, one)

    def negate(self, cs: ConstraintSystem) -> "AllocatedPoint":
        f = cs.field

        def yv():
            return None if self.y.get_value() is None else f.neg(self.y.get_value())

        y = AllocatedNum.alloc(cs, yv)
        cs.enforce(
            lc_of(self.y.get_variable()),
            lc_of(ONE),
            LinearCombination.zero() - y.get_variable(),
        )
        return AllocatedPoint(self.curve, self.x, y, self.is_infinity)

    def add(self, cs: ConstraintSystem, other: "AllocatedPoint") -> "AllocatedPoint":
        """Complete addition (ecc.rs:142-222)."""
        equal_x = alloc_num_equals(cs, self.x, other.x)
        equal_y = alloc_num_equals(cs, self.y, other.y)
        result_from_add, at_least_one_inf = self.add_internal(cs, other, equal_x)
        result_from_double = self.double(cs)
        result_for_equal_x = AllocatedPoint.select_point_or_infinity(
            cs, result_from_double, Boolean.from_bit(equal_y)
        )

        f = cs.field

        def ue_val():
            if equal_x.get_value() is None or at_least_one_inf.get_value() is None:
                return None
            ex = 1 if equal_x.get_value() else 0
            return ex * (1 - at_least_one_inf.get_value()) % f.p

        use_equal_x = AllocatedNum.alloc(cs, ue_val)
        cs.enforce(
            lc_of(equal_x.get_variable()),
            lc_of(ONE) - at_least_one_inf.get_variable(),
            lc_of(use_equal_x.get_variable()),
        )
        return AllocatedPoint.conditionally_select2_point(
            cs, result_for_equal_x, result_from_add, use_equal_x
        )

    def add_internal(
        self, cs: ConstraintSystem, other: "AllocatedPoint", equal_x: AllocatedBit
    ):
        """Chord law + identity handling (ecc.rs:227-389)."""
        f = cs.field

        def inf_or():
            a, b = self.is_infinity.get_value(), other.is_infinity.get_value()
            if a is None or b is None:
                return None
            return (1 - (1 - a) * (1 - b)) % f.p

        at_least_one_inf = AllocatedNum.alloc(cs, inf_or)
        cs.enforce(
            lc_of(ONE) - self.is_infinity.get_variable(),
            lc_of(ONE) - other.is_infinity.get_variable(),
            lc_of(ONE) - at_least_one_inf.get_variable(),
        )

        def xdia_val():
            if equal_x.get_value() is None or at_least_one_inf.get_value() is None:
                return None
            return 1 if equal_x.get_value() else at_least_one_inf.get_value()

        x_diff_is_actual = AllocatedNum.alloc(cs, xdia_val)
        cs.enforce(
            lc_of(ONE) - at_least_one_inf.get_variable(),
            lc_of(ONE) - equal_x.get_variable(),
            lc_of(ONE) - x_diff_is_actual.get_variable(),
        )

        x_diff = select_one_or_diff2(cs, other.x, self.x, x_diff_is_actual)

        def lambda_val():
            if (
                x_diff_is_actual.get_value() is None
                or other.x.get_value() is None
                or self.x.get_value() is None
                or other.y.get_value() is None
                or self.y.get_value() is None
            ):
                return None
            if x_diff_is_actual.get_value() == 1:
                inv = 1
            else:
                inv = f.inv(f.sub(other.x.get_value(), self.x.get_value()))
            return f.mul(f.sub(other.y.get_value(), self.y.get_value()), inv)

        lam = AllocatedNum.alloc(cs, lambda_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(x_diff.get_variable()),
            lc_of(other.y.get_variable()) - self.y.get_variable(),
        )

        def x_val():
            if lam.get_value() is None or self.x.get_value() is None or other.x.get_value() is None:
                return None
            return (lam.get_value() ** 2 - self.x.get_value() - other.x.get_value()) % f.p

        x = AllocatedNum.alloc(cs, x_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(lam.get_variable()),
            lc_of(x.get_variable()) + self.x.get_variable() + other.x.get_variable(),
        )

        def y_val():
            if lam.get_value() is None or x.get_value() is None:
                return None
            return (lam.get_value() * (self.x.get_value() - x.get_value()) - self.y.get_value()) % f.p

        y = AllocatedNum.alloc(cs, y_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(self.x.get_variable()) - x.get_variable(),
            lc_of(y.get_variable()) + self.y.get_variable(),
        )

        x1 = conditionally_select2(cs, self.x, x, other.is_infinity)
        x_out = conditionally_select2(cs, other.x, x1, self.is_infinity)
        y1 = conditionally_select2(cs, self.y, y, other.is_infinity)
        y_out = conditionally_select2(cs, other.y, y1, self.is_infinity)
        inf1 = select_num_or_zero2(cs, self.is_infinity, other.is_infinity)
        inf_out = conditionally_select2(cs, other.is_infinity, inf1, self.is_infinity)
        return AllocatedPoint(self.curve, x_out, y_out, inf_out), at_least_one_inf

    def double(self, cs: ConstraintSystem) -> "AllocatedPoint":
        """Tangent law, complete via selects (ecc.rs:392-491). a = 0."""
        f = cs.field

        def d(fn, *getters):
            def val():
                vals = [g() for g in getters]
                if any(v is None for v in vals):
                    return None
                return fn(*vals) % f.p

            return val

        tmp_actual = AllocatedNum.alloc(cs, d(lambda y: 2 * y, self.y.get_value))
        cs.enforce(
            lc_of(ONE) + ONE,
            lc_of(self.y.get_variable()),
            lc_of(tmp_actual.get_variable()),
        )
        tmp = select_one_or_num2(cs, tmp_actual, self.is_infinity)

        prod_1 = AllocatedNum.alloc(cs, d(lambda x: 3 * x * x, self.x.get_value))
        cs.enforce(
            LinearCombination.zero() + (3, self.x.get_variable()),
            lc_of(self.x.get_variable()),
            lc_of(prod_1.get_variable()),
        )

        def lam_val():
            if self.is_infinity.get_value() is None or prod_1.get_value() is None or tmp.get_value() is None:
                return None
            inv = 1 if self.is_infinity.get_value() == 1 else f.inv(tmp.get_value())
            return f.mul(inv, prod_1.get_value())  # a = 0

        lam = AllocatedNum.alloc(cs, lam_val)
        cs.enforce(
            lc_of(tmp.get_variable()),
            lc_of(lam.get_variable()),
            lc_of(prod_1.get_variable()),
        )

        x = AllocatedNum.alloc(
            cs, d(lambda l, xx: l * l - 2 * xx, lam.get_value, self.x.get_value)
        )
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(lam.get_variable()),
            lc_of(x.get_variable()) + self.x.get_variable() + self.x.get_variable(),
        )
        y = AllocatedNum.alloc(
            cs,
            d(
                lambda l, sx, xx, sy: l * (sx - xx) - sy,
                lam.get_value,
                self.x.get_value,
                x.get_value,
                self.y.get_value,
            ),
        )
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(self.x.get_variable()) - x.get_variable(),
            lc_of(y.get_variable()) + self.y.get_variable(),
        )
        x_f = select_zero_or_num2(cs, x, self.is_infinity)
        y_f = select_zero_or_num2(cs, y, self.is_infinity)
        return AllocatedPoint(self.curve, x_f, y_f, self.is_infinity)

    def scalar_mul(self, cs: ConstraintSystem, scalar_bits: List[AllocatedBit]) -> "AllocatedPoint":
        """Double-and-add: incomplete for the first NUM_BITS-2 bits, complete
        for the rest (ecc.rs:496-582)."""
        split_len = min(len(scalar_bits), cs.field.num_bits - 2)
        incomplete_bits = scalar_bits[:split_len]
        complete_bits = scalar_bits[split_len:]

        p = AllocatedPointNonInfinity.from_allocated_point(self)
        acc = p
        p = acc.double_incomplete(cs)
        for bit in incomplete_bits[1:]:
            temp = acc.add_incomplete(cs, p)
            acc = AllocatedPointNonInfinity.conditionally_select(
                cs, temp, acc, Boolean.from_bit(bit)
            )
            p = p.double_incomplete(cs)

        acc_pt = acc.to_allocated_point(self.curve, self.is_infinity)
        neg = self.negate(cs)
        acc_minus_initial = acc_pt.add(cs, neg)
        res = AllocatedPoint.conditionally_select_point(
            cs, acc_pt, acc_minus_initial, Boolean.from_bit(scalar_bits[0])
        )

        default = AllocatedPoint.default(cs, self.curve)
        x = conditionally_select2(cs, default.x, res.x, self.is_infinity)
        y = conditionally_select2(cs, default.y, res.y, self.is_infinity)
        acc2 = AllocatedPoint(self.curve, x, y, res.is_infinity)
        p_complete = p.to_allocated_point(self.curve, self.is_infinity)

        for bit in complete_bits:
            temp = acc2.add(cs, p_complete)
            acc2 = AllocatedPoint.conditionally_select_point(
                cs, temp, acc2, Boolean.from_bit(bit)
            )
            p_complete = p_complete.double(cs)
        return acc2

    # --- selects ---

    @staticmethod
    def conditionally_select_point(cs, a: "AllocatedPoint", b: "AllocatedPoint", condition: Boolean):
        x = conditionally_select(cs, a.x, b.x, condition)
        y = conditionally_select(cs, a.y, b.y, condition)
        inf = conditionally_select(cs, a.is_infinity, b.is_infinity, condition)
        return AllocatedPoint(a.curve, x, y, inf)

    @staticmethod
    def conditionally_select2_point(cs, a: "AllocatedPoint", b: "AllocatedPoint", condition: AllocatedNum):
        x = conditionally_select2(cs, a.x, b.x, condition)
        y = conditionally_select2(cs, a.y, b.y, condition)
        inf = conditionally_select2(cs, a.is_infinity, b.is_infinity, condition)
        return AllocatedPoint(a.curve, x, y, inf)

    @staticmethod
    def select_point_or_infinity(cs, a: "AllocatedPoint", condition: Boolean):
        x = select_num_or_zero(cs, a.x, condition)
        y = select_num_or_zero(cs, a.y, condition)
        inf = select_num_or_one(cs, a.is_infinity, condition)
        return AllocatedPoint(a.curve, x, y, inf)

    def absorb_in_ro(self, ro):
        ro.absorb(self.x)
        ro.absorb(self.y)
        ro.absorb(self.is_infinity)

    def enforce_equal(self, cs, other: "AllocatedPoint"):
        for mine, theirs in [(self.x, other.x), (self.y, other.y), (self.is_infinity, other.is_infinity)]:
            cs.enforce(
                lc_of(mine.get_variable()) - theirs.get_variable(),
                lc_of(ONE),
                LinearCombination.zero(),
            )

    def get_coordinates(self):
        return (self.x, self.y, self.is_infinity)


class AllocatedPointNonInfinity:
    """A point guaranteed non-identity (ecc.rs:698-880)."""

    __slots__ = ("x", "y")

    def __init__(self, x: AllocatedNum, y: AllocatedNum):
        self.x = x
        self.y = y

    @staticmethod
    def from_allocated_point(p: AllocatedPoint) -> "AllocatedPointNonInfinity":
        return AllocatedPointNonInfinity(p.x, p.y)

    def to_allocated_point(self, curve, is_infinity: AllocatedNum) -> AllocatedPoint:
        return AllocatedPoint(curve, self.x, self.y, is_infinity)

    def add_incomplete(self, cs: ConstraintSystem, other: "AllocatedPointNonInfinity"):
        f = cs.field

        def lam_val():
            if other.x.get_value() is None or self.x.get_value() is None:
                return None
            if other.x.get_value() == self.x.get_value():
                return 1
            return f.mul(
                f.sub(other.y.get_value(), self.y.get_value()),
                f.inv(f.sub(other.x.get_value(), self.x.get_value())),
            )

        lam = AllocatedNum.alloc(cs, lam_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(other.x.get_variable()) - self.x.get_variable(),
            lc_of(other.y.get_variable()) - self.y.get_variable(),
        )

        def x_val():
            if lam.get_value() is None:
                return None
            return (lam.get_value() ** 2 - self.x.get_value() - other.x.get_value()) % f.p

        x = AllocatedNum.alloc(cs, x_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(lam.get_variable()),
            lc_of(x.get_variable()) + self.x.get_variable() + other.x.get_variable(),
        )

        def y_val():
            if lam.get_value() is None or x.get_value() is None:
                return None
            return (lam.get_value() * (self.x.get_value() - x.get_value()) - self.y.get_value()) % f.p

        y = AllocatedNum.alloc(cs, y_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(self.x.get_variable()) - x.get_variable(),
            lc_of(y.get_variable()) + self.y.get_variable(),
        )
        return AllocatedPointNonInfinity(x, y)

    def double_incomplete(self, cs: ConstraintSystem) -> "AllocatedPointNonInfinity":
        f = cs.field
        x_sq = self.x.square(cs)

        def lam_val():
            if x_sq.get_value() is None or self.y.get_value() is None:
                return None
            n = 3 * x_sq.get_value() % f.p  # a = 0
            d = 2 * self.y.get_value() % f.p
            if d == 0:
                return 1
            return f.mul(n, f.inv(d))

        lam = AllocatedNum.alloc(cs, lam_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            LinearCombination.zero() + (2, self.y.get_variable()),
            LinearCombination.zero() + (3, x_sq.get_variable()),
        )

        def x_val():
            if lam.get_value() is None:
                return None
            return (lam.get_value() ** 2 - 2 * self.x.get_value()) % f.p

        x = AllocatedNum.alloc(cs, x_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(lam.get_variable()),
            lc_of(x.get_variable()) + (2, self.x.get_variable()),
        )

        def y_val():
            if lam.get_value() is None or x.get_value() is None:
                return None
            return (lam.get_value() * (self.x.get_value() - x.get_value()) - self.y.get_value()) % f.p

        y = AllocatedNum.alloc(cs, y_val)
        cs.enforce(
            lc_of(lam.get_variable()),
            lc_of(self.x.get_variable()) - x.get_variable(),
            lc_of(y.get_variable()) + self.y.get_variable(),
        )
        return AllocatedPointNonInfinity(x, y)

    @staticmethod
    def conditionally_select(cs, a, b, condition: Boolean) -> "AllocatedPointNonInfinity":
        x = conditionally_select(cs, a.x, b.x, condition)
        y = conditionally_select(cs, a.y, b.y, condition)
        return AllocatedPointNonInfinity(x, y)
