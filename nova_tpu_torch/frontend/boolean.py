"""Bit gadgets (reference: src/frontend/gadgets/boolean.rs, a bellpepper
port). AllocatedBit enforces booleanity with (1 - a)·a = 0; Boolean wraps an
AllocatedBit, its negation, or a constant."""

from __future__ import annotations

from typing import List, Optional

from nova_tpu_torch.errors import AssignmentMissingError, UnSatError
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE, Variable


class AllocatedBit:
    __slots__ = ("variable", "value")

    def __init__(self, variable: Variable, value: Optional[bool]):
        self.variable = variable
        self.value = value

    def get_value(self):
        return self.value

    def get_variable(self):
        return self.variable

    @staticmethod
    def _alloc_bit(cs: ConstraintSystem, value) -> "AllocatedBit":
        """Allocate a bit from a bool / None / closure-returning-bool."""
        var, v = cs.alloc2(value)
        bit = AllocatedBit(var, v)
        cs.bind(var, bit)
        return bit

    @staticmethod
    def alloc(cs: ConstraintSystem, value) -> "AllocatedBit":
        bit = AllocatedBit._alloc_bit(cs, value)
        # (1 - a) * a = 0
        cs.enforce(
            LinearCombination.from_variable(ONE) - bit.variable,
            LinearCombination.from_variable(bit.variable),
            LinearCombination.zero(),
        )
        return bit

    @staticmethod
    def alloc_conditionally(
        cs: ConstraintSystem, value, must_be_false: "AllocatedBit"
    ) -> "AllocatedBit":
        bit = AllocatedBit._alloc_bit(cs, value)
        # (1 - must_be_false - a) * a = 0 (boolean.rs:42-80)
        cs.enforce(
            LinearCombination.from_variable(ONE) - must_be_false.variable - bit.variable,
            LinearCombination.from_variable(bit.variable),
            LinearCombination.zero(),
        )
        return bit

    @staticmethod
    def xor(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        def _val():
            if a.value is None or b.value is None:
                return None
            return (a.value != b.value)

        bit = AllocatedBit._alloc_bit(cs, _val)
        var = bit.variable
        # (2a) * b = a + b - c  (boolean.rs:116)
        cs.enforce(
            LinearCombination.zero() + (2, a.variable),
            LinearCombination.from_variable(b.variable),
            LinearCombination.from_variable(a.variable) + b.variable - var,
        )
        return bit

    @staticmethod
    def and_(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        def _val():
            if a.value is None or b.value is None:
                return None
            return (a.value and b.value)

        bit = AllocatedBit._alloc_bit(cs, _val)
        var = bit.variable
        # a * b = c
        cs.enforce(
            LinearCombination.from_variable(a.variable),
            LinearCombination.from_variable(b.variable),
            LinearCombination.from_variable(var),
        )
        return bit

    @staticmethod
    def and_not(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        def _val():
            if a.value is None or b.value is None:
                return None
            return (a.value and not b.value)

        bit = AllocatedBit._alloc_bit(cs, _val)
        var = bit.variable
        # a * (1 - b) = c
        cs.enforce(
            LinearCombination.from_variable(a.variable),
            LinearCombination.from_variable(ONE) - b.variable,
            LinearCombination.from_variable(var),
        )
        return bit

    @staticmethod
    def nor(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        def _val():
            if a.value is None or b.value is None:
                return None
            return (not a.value and not b.value)

        bit = AllocatedBit._alloc_bit(cs, _val)
        var = bit.variable
        # (1 - a) * (1 - b) = c
        cs.enforce(
            LinearCombination.from_variable(ONE) - a.variable,
            LinearCombination.from_variable(ONE) - b.variable,
            LinearCombination.from_variable(var),
        )
        return bit


def field_into_allocated_bits_le(cs: ConstraintSystem, value) -> List[AllocatedBit]:
    """Allocate the NUM_BITS little-endian bits of a field element
    (boolean.rs:291; no in-field strictness). `value` may be an int, None,
    or an AllocatedNum-like wrapper (read lazily for tape replay)."""
    num_bits = cs.field.num_bits
    if value is None or isinstance(value, int):
        getter = lambda: value  # noqa: E731
    else:
        getter = value.get_value
    bits = []
    for i in range(num_bits):
        def b(i=i):
            v = getter()
            return None if v is None else bool((v >> i) & 1)

        bits.append(AllocatedBit.alloc(cs, b))
    return bits


class Boolean:
    """A bit: allocated, negated-allocated, or constant (boolean.rs:338+)."""

    __slots__ = ("kind", "bit", "const_val")

    def __init__(self, kind: str, bit: Optional[AllocatedBit] = None, const_val: bool = False):
        self.kind = kind  # 'is' | 'not' | 'const'
        self.bit = bit
        self.const_val = const_val

    @staticmethod
    def from_bit(bit: AllocatedBit) -> "Boolean":
        return Boolean("is", bit)

    @staticmethod
    def constant(b: bool) -> "Boolean":
        return Boolean("const", const_val=b)

    def is_constant(self) -> bool:
        return self.kind == "const"

    def get_value(self) -> Optional[bool]:
        if self.kind == "const":
            return self.const_val
        if self.bit.value is None:
            return None
        return self.bit.value if self.kind == "is" else not self.bit.value

    def not_(self) -> "Boolean":
        if self.kind == "const":
            return Boolean.constant(not self.const_val)
        return Boolean("not" if self.kind == "is" else "is", self.bit)

    def lc(self, one: Variable, coeff: int) -> LinearCombination:
        if self.kind == "const":
            out = LinearCombination.zero()
            if self.const_val:
                out.add_term(coeff, one)
            return out
        if self.kind == "is":
            return LinearCombination.zero() + (coeff, self.bit.variable)
        return LinearCombination.zero() + (coeff, one) - (coeff, self.bit.variable)

    @staticmethod
    def enforce_equal(cs: ConstraintSystem, a: "Boolean", b: "Boolean"):
        # boolean.rs:356: constant/constant checked; otherwise (a-b)*1=0
        av, bv = a.get_value(), b.get_value()
        if a.is_constant() and b.is_constant():
            if av != bv:
                raise UnSatError("unequal constant booleans")
            return
        cs.enforce(
            a.lc(ONE, 1) - b.lc(ONE, 1),
            LinearCombination.from_variable(ONE),
            LinearCombination.zero(),
        )

    @staticmethod
    def xor(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        # constants short-circuit (boolean.rs:445-463)
        if a.is_constant():
            return b if not a.const_val else b.not_()
        if b.is_constant():
            return a if not b.const_val else a.not_()
        if a.kind == "is" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        if a.kind == "not" and b.kind == "not":
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        # is ^ not = not(xor)
        return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit)).not_()

    @staticmethod
    def and_(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        # boolean.rs:466-489
        if a.is_constant():
            return b if a.const_val else Boolean.constant(False)
        if b.is_constant():
            return a if b.const_val else Boolean.constant(False)
        if a.kind == "is" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))
        if a.kind == "is" and b.kind == "not":
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.kind == "not" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))

    @staticmethod
    def or_(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        # not(and(not a, not b)) (boolean.rs:491-505)
        return Boolean.and_(cs, a.not_(), b.not_()).not_()


def _bool_ch_value(a, b, c):
    if a is None or b is None or c is None:
        return None
    return (a and b) ^ ((not a) and c)


def _bool_maj_value(a, b, c):
    if a is None or b is None or c is None:
        return None
    return (a and b) ^ (a and c) ^ (b and c)


def sha256_ch(cs: ConstraintSystem, a: Boolean, b: Boolean, c: Boolean) -> Boolean:
    """(a and b) xor ((not a) and c) — one constraint in the allocated case
    (boolean.rs:508-616)."""
    ch_value = _bool_ch_value(a.get_value(), b.get_value(), c.get_value())
    if a.is_constant() and b.is_constant() and c.is_constant():
        return Boolean.constant(ch_value)
    if a.is_constant() and not a.const_val:
        return c
    if b.is_constant() and not b.const_val:
        return Boolean.and_(cs, a.not_(), c)
    if c.is_constant() and not c.const_val:
        return Boolean.and_(cs, a, b)
    if c.is_constant() and c.const_val:
        return Boolean.and_(cs, a, b.not_()).not_()
    if b.is_constant() and b.const_val:
        return Boolean.and_(cs, a.not_(), c.not_()).not_()
    # a constant-true falls through like the reference ("just continue")
    ch = AllocatedBit._alloc_bit(
        cs, lambda: _bool_ch_value(a.get_value(), b.get_value(), c.get_value())
    )
    # (b - c) * a = ch - c
    cs.enforce(
        b.lc(ONE, 1) - c.lc(ONE, 1),
        a.lc(ONE, 1),
        LinearCombination.from_variable(ch.get_variable()) - c.lc(ONE, 1),
    )
    return Boolean.from_bit(ch)


def sha256_maj(cs: ConstraintSystem, a: Boolean, b: Boolean, c: Boolean) -> Boolean:
    """(a and b) xor (a and c) xor (b and c) — two constraints
    (boolean.rs:618-740)."""
    maj_value = _bool_maj_value(a.get_value(), b.get_value(), c.get_value())
    if a.is_constant() and b.is_constant() and c.is_constant():
        return Boolean.constant(maj_value)
    if a.is_constant() and not a.const_val:
        return Boolean.and_(cs, b, c)
    if b.is_constant() and not b.const_val:
        return Boolean.and_(cs, a, c)
    if c.is_constant() and not c.const_val:
        return Boolean.and_(cs, a, b)
    if c.is_constant() and c.const_val:
        return Boolean.and_(cs, a.not_(), b.not_()).not_()
    if b.is_constant() and b.const_val:
        return Boolean.and_(cs, a.not_(), c.not_()).not_()
    if a.is_constant() and a.const_val:
        return Boolean.and_(cs, b.not_(), c.not_()).not_()
    maj = AllocatedBit._alloc_bit(
        cs, lambda: _bool_maj_value(a.get_value(), b.get_value(), c.get_value())
    )
    bc = Boolean.and_(cs, b, c)
    # (2bc - b - c) * a = bc - maj
    cs.enforce(
        bc.lc(ONE, 1) + bc.lc(ONE, 1) - b.lc(ONE, 1) - c.lc(ONE, 1),
        a.lc(ONE, 1),
        bc.lc(ONE, 1) - (1, maj.get_variable()),
    )
    return Boolean.from_bit(maj)
