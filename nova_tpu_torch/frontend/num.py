"""Number gadgets (reference: src/frontend/gadgets/num.rs).

Witness values follow the tape discipline (frontend/tape.py): every
allocation passes a closure that reads only `.value` of previously
allocated wrappers, so a recorded tape can replay with fresh inputs."""

from __future__ import annotations

from typing import List, Optional

from nova_tpu_torch.errors import AssignmentMissingError, NovaError
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean, field_into_allocated_bits_le
from nova_tpu_torch.frontend.constraint_system import (
    ConstraintSystem,
    LinearCombination,
    ONE,
    Variable,
)
from nova_tpu_torch.frontend import tape as _tape


class AllocatedNum:
    __slots__ = ("value", "variable")

    def __init__(self, variable: Variable, value: Optional[int]):
        self.variable = variable
        self.value = value

    def get_value(self):
        return self.value

    def get_variable(self):
        return self.variable

    @staticmethod
    def from_parts(variable: Variable, value: Optional[int]) -> "AllocatedNum":
        return AllocatedNum(variable, value)

    @staticmethod
    def one(cs: ConstraintSystem) -> "AllocatedNum":
        return AllocatedNum(ONE, 1)

    @staticmethod
    def alloc(cs: ConstraintSystem, value) -> "AllocatedNum":
        var, v = cs.alloc2(value)
        num = AllocatedNum(var, v)
        cs.bind(var, num)
        return num

    @staticmethod
    def alloc_input(cs: ConstraintSystem, value) -> "AllocatedNum":
        var, v = cs.alloc_input2(value)
        num = AllocatedNum(var, v)
        cs.bind(var, num)
        return num

    def inputize(self, cs: ConstraintSystem):
        inp = cs.alloc_input(lambda: self.value)
        cs.enforce(
            LinearCombination.from_variable(inp),
            LinearCombination.from_variable(ONE),
            LinearCombination.from_variable(self.variable),
        )

    def add(self, cs: ConstraintSystem, other: "AllocatedNum") -> "AllocatedNum":
        p = cs.field.p

        def val():
            if self.value is None or other.value is None:
                return None
            return (self.value + other.value) % p

        out = AllocatedNum.alloc(cs, val)
        cs.enforce(
            LinearCombination.from_variable(self.variable) + other.variable,
            LinearCombination.from_variable(ONE),
            LinearCombination.from_variable(out.variable),
        )
        return out

    def mul(self, cs: ConstraintSystem, other: "AllocatedNum") -> "AllocatedNum":
        p = cs.field.p

        def val():
            if self.value is None or other.value is None:
                return None
            return self.value * other.value % p

        out = AllocatedNum.alloc(cs, val)
        cs.enforce(
            LinearCombination.from_variable(self.variable),
            LinearCombination.from_variable(other.variable),
            LinearCombination.from_variable(out.variable),
        )
        return out

    def square(self, cs: ConstraintSystem) -> "AllocatedNum":
        p = cs.field.p

        def val():
            if self.value is None:
                return None
            return self.value * self.value % p

        out = AllocatedNum.alloc(cs, val)
        cs.enforce(
            LinearCombination.from_variable(self.variable),
            LinearCombination.from_variable(self.variable),
            LinearCombination.from_variable(out.variable),
        )
        return out

    def assert_nonzero(self, cs: ConstraintSystem):
        f = cs.field

        def inv_val():
            if self.value is None:
                return None
            if self.value == 0:
                raise NovaError("assert_nonzero on zero")
            return f.inv(self.value)

        inv = cs.alloc(inv_val)
        cs.enforce(
            LinearCombination.from_variable(self.variable),
            LinearCombination.from_variable(inv),
            LinearCombination.from_variable(ONE),
        )

    def to_bits_le(self, cs: ConstraintSystem) -> List[Boolean]:
        bits = field_into_allocated_bits_le(cs, self)
        lc = LinearCombination.zero()
        coeff = 1
        for bit in bits:
            lc.add_term(coeff, bit.variable)
            coeff <<= 1
        lc = lc - self.variable
        cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc)
        return [Boolean.from_bit(b) for b in bits]

    def to_bits_le_strict(self, cs: ConstraintSystem) -> List[Boolean]:
        """Strict in-field decomposition (num.rs:149-272): while emitting
        big-endian bits of the value, run k-ary ANDs over the runs of ones
        of p-1 so that bits in 'free' positions are forced to zero whenever
        all more-significant one-run bits are set."""
        field = cs.field
        num_bits = field.num_bits
        b_be = [bool(((field.p - 1) >> i) & 1) for i in range(num_bits)][::-1]

        def a_bit_fn(pos):
            # big-endian position `pos` == little-endian bit num_bits-1-pos
            shift = num_bits - 1 - pos

            def fn():
                if self.value is None:
                    return None
                return bool((self.value >> shift) & 1)

            return fn

        def kary_and(bits_: List[AllocatedBit]) -> AllocatedBit:
            cur = bits_[0]
            for b in bits_[1:]:
                cur = AllocatedBit.and_(cs, cur, b)
            return cur

        result: List[AllocatedBit] = []
        last_run: Optional[AllocatedBit] = None
        current_run: List[AllocatedBit] = []
        found_one = False
        ai = 0
        for b in b_be:
            pos = ai
            ai += 1
            found_one = found_one or b
            if not found_one:
                continue
            if b:
                bit = AllocatedBit.alloc(cs, a_bit_fn(pos))
                current_run.append(bit)
                result.append(bit)
            else:
                if current_run:
                    if last_run is not None:
                        current_run.append(last_run)
                    last_run = kary_and(current_run)
                    current_run = []
                bit = AllocatedBit.alloc_conditionally(cs, a_bit_fn(pos), last_run)
                result.append(bit)
        assert not current_run

        lc = LinearCombination.zero()
        coeff = 1
        for bit in reversed(result):
            lc.add_term(coeff, bit.variable)
            coeff <<= 1
        lc = lc - self.variable
        cs.enforce(LinearCombination.zero(), LinearCombination.zero(), lc)
        return [Boolean.from_bit(b) for b in reversed(result)]

    @staticmethod
    def conditionally_reverse(cs, a: "AllocatedNum", b: "AllocatedNum", condition: Boolean):
        def val_c():
            cv = condition.get_value()
            if cv is None or a.value is None or b.value is None:
                return None
            return b.value if cv else a.value

        def val_d():
            cv = condition.get_value()
            if cv is None or a.value is None or b.value is None:
                return None
            return a.value if cv else b.value

        c = AllocatedNum.alloc(cs, val_c)
        cs.enforce(
            LinearCombination.from_variable(a.variable) - b.variable,
            condition.lc(ONE, 1),
            LinearCombination.from_variable(a.variable) - c.variable,
        )
        d = AllocatedNum.alloc(cs, val_d)
        cs.enforce(
            LinearCombination.from_variable(b.variable) - a.variable,
            condition.lc(ONE, 1),
            LinearCombination.from_variable(b.variable) - d.variable,
        )
        return c, d


class Num:
    """A number as a linear combination (num.rs:495-578). The value may be
    a plain int or an epoch-memoized Lazy (tape mode)."""

    __slots__ = ("_value", "lc")

    def __init__(self, value: Optional[int] = 0, lc: Optional[LinearCombination] = None):
        self._value = value
        self.lc = lc if lc is not None else LinearCombination.zero()

    # `.value` resolves lazily so tape replays observe fresh values.
    @property
    def value(self):
        v = self._value
        if isinstance(v, _tape.Lazy):
            return v.get()
        return v

    @staticmethod
    def zero() -> "Num":
        return Num(0, LinearCombination.zero())

    @staticmethod
    def from_allocated(num: AllocatedNum) -> "Num":
        if _tape.TRACING:
            return Num(
                _tape.Lazy(lambda: num.value), LinearCombination.from_variable(num.variable)
            )
        return Num(num.value, LinearCombination.from_variable(num.variable))

    def get_value(self):
        return self.value

    def to_lc(self, coeff: int = 1) -> LinearCombination:
        return LinearCombination.zero().add_lc(self.lc, coeff)

    def add_bool_with_coeff(self, one: Variable, bit: Boolean, coeff: int, p: int) -> "Num":
        if _tape.TRACING:

            def fn():
                bv = bit.get_value()
                if self.value is None or bv is None:
                    return None
                return (self.value + coeff) % p if bv else self.value

            return Num(_tape.Lazy(fn), self.lc.copy().add_lc(bit.lc(one, coeff)))
        bv = bit.get_value()
        if self.value is None or bv is None:
            newval = None
        else:
            newval = (self.value + coeff) % p if bv else self.value
        return Num(newval, self.lc.copy().add_lc(bit.lc(one, coeff)))

    def add(self, other: "Num", p: int) -> "Num":
        if _tape.TRACING:

            def fn():
                sv, ov = self.value, other.value
                if sv is None or ov is None:
                    return sv if ov is None else ov
                return (sv + ov) % p

            return Num(_tape.Lazy(fn), self.lc.copy().add_lc(other.lc))
        if self.value is None or other.value is None:
            v = self.value if other.value is None else other.value
        else:
            v = (self.value + other.value) % p
        return Num(v, self.lc.copy().add_lc(other.lc))

    def scale(self, scalar: int, p: int) -> "Num":
        lc = self.lc.copy().scale(scalar)
        if _tape.TRACING:
            return Num(
                _tape.Lazy(lambda: None if self.value is None else self.value * scalar % p),
                lc,
            )
        v = None if self.value is None else self.value * scalar % p
        return Num(v, lc)
