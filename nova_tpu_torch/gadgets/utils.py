"""Low-level gadget utilities (reference: src/gadgets/utils.rs)."""

from __future__ import annotations

from typing import List, Optional

from nova_tpu_torch.constants import BN_LIMB_WIDTH, BN_N_LIMBS
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE
from nova_tpu_torch.frontend.num import AllocatedNum


def _maybe(fn, *vals):
    """Apply fn if all vals are not None, else None (shape-mode safe)."""
    if any(v is None for v in vals):
        return None
    return fn(*vals)


def lc_of(var) -> LinearCombination:
    return LinearCombination.from_variable(var)


def alloc_zero(cs: ConstraintSystem) -> AllocatedNum:
    zero = AllocatedNum.alloc(cs, 0)
    cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc_of(zero.get_variable()))
    return zero


def alloc_one(cs: ConstraintSystem) -> AllocatedNum:
    return AllocatedNum(ONE, 1)


def alloc_constant(cs: ConstraintSystem, c: int) -> AllocatedNum:
    const = AllocatedNum.alloc(cs, c)
    cs.enforce(
        lc_of(const.get_variable()),
        lc_of(ONE),
        LinearCombination.zero() + (c, ONE),
    )
    return const


def alloc_scalar_as_base(cs: ConstraintSystem, scalar_value) -> AllocatedNum:
    """Allocate a scalar-field value in a base-field circuit (bit-copy;
    utils.rs:56-78). None defaults to zero (unwrap_or(ZERO) in the
    reference), so optional base-case inputs still synthesize witnesses.
    Accepts an int/None or a closure (tape mode)."""
    p = cs.field.p

    def val():
        v = scalar_value() if callable(scalar_value) else scalar_value
        return 0 if v is None else v % p

    return AllocatedNum.alloc(cs, val)


def scalar_as_base(engine, x: int) -> int:
    """field_switch (utils.rs:93-104): sum of bits mod target."""
    return x % engine.base.p


def base_as_scalar(engine, x: int) -> int:
    return x % engine.scalar.p


def le_bits_to_num(cs: ConstraintSystem, bits: List[AllocatedBit]) -> AllocatedNum:
    p = cs.field.p
    lc = LinearCombination.zero()
    coeff = 1
    for bit in bits:
        lc.add_term(coeff, bit.get_variable())
        coeff <<= 1

    def val():
        fe = 0
        c = 1
        for bit in bits:
            bv = bit.get_value()
            if bv is None:
                return None
            if bv:
                fe = (fe + c) % p
            c <<= 1
        return fe

    num = AllocatedNum.alloc(cs, val)
    lc = lc - num.get_variable()
    cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc)
    return num


def alloc_num_equals(cs: ConstraintSystem, a: AllocatedNum, b: AllocatedNum) -> AllocatedBit:
    """Equality bit (utils.rs:143-184)."""
    f = cs.field
    r = AllocatedBit.alloc(
        cs, lambda: _maybe(lambda x, y: x == y, a.get_value(), b.get_value())
    )

    def t_val():
        if a.get_value() is None or b.get_value() is None:
            return None
        if a.get_value() == b.get_value():
            return 1
        return f.inv(f.sub(a.get_value(), b.get_value()))

    t = AllocatedNum.alloc(cs, t_val)
    cs.enforce(
        lc_of(t.get_variable()),
        lc_of(a.get_variable()) - b.get_variable(),
        lc_of(ONE) - r.get_variable(),
    )
    cs.enforce(
        lc_of(r.get_variable()),
        lc_of(a.get_variable()) - b.get_variable(),
        LinearCombination.zero(),
    )
    return r


def conditionally_select(cs, a: AllocatedNum, b: AllocatedNum, condition: Boolean) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (a.get_value() if cv else b.get_value())

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(a.get_variable()) - b.get_variable(),
        condition.lc(ONE, 1),
        lc_of(c.get_variable()) - b.get_variable(),
    )
    return c


def conditionally_select_vec(cs, a, b, condition):
    return [conditionally_select(cs, x, y, condition) for x, y in zip(a, b)]


def conditionally_select2(cs, a: AllocatedNum, b: AllocatedNum, condition: AllocatedNum) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (a.get_value() if cv == 1 else b.get_value())

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(a.get_variable()) - b.get_variable(),
        lc_of(condition.get_variable()),
        lc_of(c.get_variable()) - b.get_variable(),
    )
    return c


def select_zero_or_num2(cs, a: AllocatedNum, condition: AllocatedNum) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (0 if cv == 1 else a.get_value())

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(a.get_variable()),
        lc_of(ONE) - condition.get_variable(),
        lc_of(c.get_variable()),
    )
    return c


def select_num_or_zero2(cs, a: AllocatedNum, condition: AllocatedNum) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (a.get_value() if cv == 1 else 0)

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(a.get_variable()),
        lc_of(condition.get_variable()),
        lc_of(c.get_variable()),
    )
    return c


def select_num_or_zero(cs, a: AllocatedNum, condition: Boolean) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (a.get_value() if cv else 0)

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(lc_of(a.get_variable()), condition.lc(ONE, 1), lc_of(c.get_variable()))
    return c


def select_one_or_num2(cs, a: AllocatedNum, condition: AllocatedNum) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (1 if cv == 1 else a.get_value())

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(ONE) - a.get_variable(),
        lc_of(condition.get_variable()),
        lc_of(c.get_variable()) - a.get_variable(),
    )
    return c


def select_one_or_diff2(cs, a: AllocatedNum, b: AllocatedNum, condition: AllocatedNum) -> AllocatedNum:
    f = cs.field

    def val():
        cv = condition.get_value()
        if cv is None or a.get_value() is None or b.get_value() is None:
            return None
        return 1 if cv == 1 else f.sub(a.get_value(), b.get_value())

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(ONE) - a.get_variable() + b.get_variable(),
        lc_of(condition.get_variable()),
        lc_of(c.get_variable()) - a.get_variable() + b.get_variable(),
    )
    return c


def select_num_or_one(cs, a: AllocatedNum, condition: Boolean) -> AllocatedNum:
    def val():
        cv = condition.get_value()
        return None if cv is None else (a.get_value() if cv else 1)

    c = AllocatedNum.alloc(cs, val)
    cs.enforce(
        lc_of(a.get_variable()) - (1, ONE),
        condition.lc(ONE, 1),
        lc_of(c.get_variable()) - (1, ONE),
    )
    return c
