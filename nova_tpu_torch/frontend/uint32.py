"""UInt32 + MultiEq gadgets (port of ``nova_tpu/frontend/uint32.py``;
reference: src/frontend/gadgets/{uint32,multieq}.rs).

UInt32 holds 32 Booleans little-endian plus an optional concrete value;
`addmany` sums up to 10 operands with carry bits, batching the equality
into a MultiEq accumulator (one constraint per ~capacity bits).

Witness tapes (frontend/tape.py) replay only value closures: `addmany`'s
result bits take closures that sum their operands' bits again on each
replay (one sum per replay, memoized in a Lazy), where the JAX package
allocates them as trace-time constants, which a replay would leave stale.
A word's ``.value`` is trace-time metadata that no closure reads. The
shapes and the witnesses are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

from nova_tpu_torch.frontend.boolean import (
    AllocatedBit,
    Boolean,
    sha256_ch,
    sha256_maj,
)
from nova_tpu_torch.frontend.constraint_system import (
    ConstraintSystem,
    LinearCombination,
    ONE,
)
from nova_tpu_torch.frontend.tape import Lazy


class MultiEq:
    """Batches bounded-width equalities into shared constraints
    (multieq.rs:9-95). Call `drain()` (or use as context manager) when done."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.ops = 0
        self.bits_used = 0
        self.lhs = LinearCombination.zero()
        self.rhs = LinearCombination.zero()

    def _accumulate(self):
        self.cs.enforce(
            self.lhs,
            LinearCombination.from_variable(ONE),
            self.rhs,
        )
        self.lhs = LinearCombination.zero()
        self.rhs = LinearCombination.zero()
        self.bits_used = 0
        self.ops += 1

    def enforce_equal(self, num_bits: int, lhs: LinearCombination, rhs: LinearCombination):
        capacity = self.cs.field.num_bits - 1
        if capacity <= self.bits_used + num_bits:
            self._accumulate()
        assert capacity > self.bits_used + num_bits
        coeff = 1 << self.bits_used
        self.lhs = self.lhs + lhs.copy().scale(coeff)
        self.rhs = self.rhs + rhs.copy().scale(coeff)
        self.bits_used += num_bits

    def drain(self):
        if self.bits_used > 0:
            self._accumulate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.drain()
        return False


class UInt32:
    """32-bit word of Booleans, bits little-endian (uint32.rs:16-22)."""

    __slots__ = ("bits", "value")

    def __init__(self, bits: List[Boolean], value: Optional[int]):
        assert len(bits) == 32
        self.bits = bits
        self.value = value

    @staticmethod
    def constant(value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        bits = [Boolean.constant(bool((value >> i) & 1)) for i in range(32)]
        return UInt32(bits, value)

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[int]) -> "UInt32":
        bits = [
            Boolean.from_bit(
                AllocatedBit.alloc(
                    cs, None if value is None else bool((value >> i) & 1)
                )
            )
            for i in range(32)
        ]
        return UInt32(bits, value)

    def into_bits_be(self) -> List[Boolean]:
        return list(reversed(self.bits))

    @staticmethod
    def from_bits_be(bits: List[Boolean]) -> "UInt32":
        assert len(bits) == 32
        value = 0
        known = True
        for b in bits:
            v = b.get_value()
            if v is None:
                known = False
            value = (value << 1) | (1 if v else 0)
        return UInt32(list(reversed(bits)), value & 0xFFFFFFFF if known else None)

    @staticmethod
    def from_bits(bits: List[Boolean]) -> "UInt32":
        """little-endian (uint32.rs:59-79)."""
        assert len(bits) == 32
        value = 0
        known = True
        for i, b in enumerate(bits):
            v = b.get_value()
            if v is None:
                known = False
            elif v:
                value |= 1 << i
        return UInt32(list(bits), value if known else None)

    def rotr(self, by: int) -> "UInt32":
        by %= 32
        bits = [self.bits[(i + by) % 32] for i in range(32)]
        val = None if self.value is None else (
            ((self.value >> by) | (self.value << (32 - by))) & 0xFFFFFFFF
        )
        return UInt32(bits, val)

    def shr(self, by: int) -> "UInt32":
        fill = [Boolean.constant(False)] * by
        bits = self.bits[by:] + fill
        val = None if self.value is None else (self.value >> by)
        return UInt32(bits[:32], val)

    def xor(self, cs: ConstraintSystem, other: "UInt32") -> "UInt32":
        val = None
        if self.value is not None and other.value is not None:
            val = self.value ^ other.value
        bits = [Boolean.xor(cs, a, b) for a, b in zip(self.bits, other.bits)]
        return UInt32(bits, val)

    @staticmethod
    def sha256_maj(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        val = None
        if a.value is not None and b.value is not None and c.value is not None:
            val = (a.value & b.value) ^ (a.value & c.value) ^ (b.value & c.value)
        bits = [sha256_maj(cs, x, y, z) for x, y, z in zip(a.bits, b.bits, c.bits)]
        return UInt32(bits, val)

    @staticmethod
    def sha256_ch(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        val = None
        if a.value is not None and b.value is not None and c.value is not None:
            val = (a.value & b.value) ^ (~a.value & c.value) & 0xFFFFFFFF
        bits = [sha256_ch(cs, x, y, z) for x, y, z in zip(a.bits, b.bits, c.bits)]
        return UInt32(bits, val)

    @staticmethod
    def addmany(meq: MultiEq, operands: List["UInt32"]) -> "UInt32":
        """Modular 32-bit addition of 2..10 operands (uint32.rs:211-300)."""
        cs = meq.cs
        assert cs.field.num_bits >= 64
        assert 2 <= len(operands) <= 10

        max_value = len(operands) * 0xFFFFFFFF
        result_value = 0
        known = True

        lc = LinearCombination.zero()
        all_constants = True
        for op in operands:
            if op.value is None:
                known = False
            else:
                result_value += op.value
            coeff = 1
            for bit in op.bits:
                lc = lc + bit.lc(ONE, coeff)
                all_constants = all_constants and bit.is_constant()
                coeff <<= 1

        modular_value = (result_value & 0xFFFFFFFF) if known else None

        if all_constants and known:
            return UInt32.constant(modular_value)

        # the operands' sum from their bits' current values: what each
        # result bit's closure reads, on every replay of a witness tape
        op_bits = [op.bits for op in operands]

        def _sum():
            total = 0
            for bits in op_bits:
                for k, bit in enumerate(bits):
                    v = bit.get_value()
                    if v is None:
                        return None
                    if v:
                        total += 1 << k
            return total

        total = Lazy(_sum)

        def _bit(i):
            return lambda: None if total.get() is None else bool((total.get() >> i) & 1)

        # allocate result bits up to max_value's width
        result_bits: List[Boolean] = []
        result_lc = LinearCombination.zero()
        i = 0
        mv = max_value
        while mv != 0:
            b = AllocatedBit.alloc(cs, _bit(i))
            result_lc = result_lc + (1 << i, b.get_variable())
            result_bits.append(Boolean.from_bit(b))
            i += 1
            mv >>= 1

        meq.enforce_equal(i, lc, result_lc)
        return UInt32(result_bits[:32], modular_value)
