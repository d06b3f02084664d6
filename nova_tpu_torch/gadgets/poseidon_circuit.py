"""In-circuit Poseidon sponge (reference: poseidon circuit2.rs +
sponge/circuit.rs + src/provider/poseidon.rs PoseidonROCircuit).

The circuit evaluates the same optimized-static permutation as the native
sponge; MDS mixing stays in linear-combination space (zero constraints), so
each full round costs 3·width constraints (2 squarings + 1 mul_sum per
s-box) and each partial round costs 3.

We use one code path for both shape and witness constraint systems (the
reference has a specialized witness generator, circuit2_witness.rs, that
must allocate identically; running the same path guarantees alignment)."""

from __future__ import annotations

from typing import List, Optional

from nova_tpu_torch.errors import AssignmentMissingError
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE
from nova_tpu_torch.frontend.num import AllocatedNum, Num
from nova_tpu_torch.frontend import tape as _tape
from nova_tpu_torch.provider.poseidon import (
    PoseidonConstants,
    PoseidonROConstants,
    io_pattern_value,
    native_ctx,
)


class Elt:
    """Value + linear combination accumulator (circuit2.rs Elt).

    VALUE_ONLY is the witness-generation fast path (the reference ships a
    dedicated circuit2_witness.rs for the same reason): when the enclosing
    constraint system only collects witness values, the LC accumulators —
    which dominate synthesis time via dict merges in the MDS products —
    are replaced by empty LCs. Allocation order is IDENTICAL to the
    constraint path because the control flow is shared; only the symbolic
    bookkeeping is skipped."""

    VALUE_ONLY = False

    __slots__ = ("allocated", "num")

    def __init__(self, allocated: Optional[AllocatedNum] = None, num: Optional[Num] = None):
        self.allocated = allocated
        self.num = num

    @staticmethod
    def from_allocated(a: AllocatedNum) -> "Elt":
        return Elt(allocated=a)

    @staticmethod
    def num_from_fr(fr: int) -> "Elt":
        return Elt(num=Num(fr, LinearCombination.zero().add_term(fr, ONE)))

    def val(self) -> Optional[int]:
        if self.allocated is not None:
            return self.allocated.get_value()
        return self.num.get_value()

    def lc(self) -> LinearCombination:
        if Elt.VALUE_ONLY:
            return LinearCombination.zero()
        if self.allocated is not None:
            return LinearCombination.from_variable(self.allocated.get_variable())
        return self.num.to_lc(1)

    def to_num(self) -> Num:
        if Elt.VALUE_ONLY:
            if _tape.TRACING:
                return Num(_tape.Lazy(self.val), LinearCombination.zero())
            v = (
                self.allocated.get_value()
                if self.allocated is not None
                else self.num.get_value()
            )
            return Num(v, LinearCombination.zero())
        if self.allocated is not None:
            return Num.from_allocated(self.allocated)
        return self.num

    def add(self, other: "Elt", p: int) -> "Elt":
        return Elt(num=self.to_num().add(other.to_num(), p))

    def scale(self, scalar: int, p: int) -> "Elt":
        return Elt(num=self.to_num().scale(scalar, p))

    def square(self, cs: ConstraintSystem) -> AllocatedNum:
        if self.allocated is not None:
            return self.allocated.square(cs)
        p = cs.field.p

        def sq():
            v = self.num.get_value()
            return None if v is None else v * v % p

        out = AllocatedNum.alloc(cs, sq)
        cs.enforce(self.num.to_lc(1), self.num.to_lc(1),
                   LinearCombination.from_variable(out.get_variable()))
        return out

    def ensure_allocated(self, cs: ConstraintSystem) -> AllocatedNum:
        v = AllocatedNum.alloc(cs, self.val)
        cs.enforce(
            self.lc(),
            LinearCombination.from_variable(ONE),
            LinearCombination.from_variable(v.get_variable()),
        )
        return v


def _mul_sum(cs, a: AllocatedNum, b: Elt, pre_add, post_add) -> AllocatedNum:
    """(a * (pre_add + b)) + post_add, one constraint (circuit2.rs:503-562)."""
    p = cs.field.p

    def v():
        bv = b.val()
        if bv is None or a.get_value() is None:
            return None
        tmp = bv
        if pre_add is not None:
            tmp = (tmp + pre_add) % p
        tmp = tmp * a.get_value() % p
        if post_add is not None:
            tmp = (tmp + post_add) % p
        return tmp

    res = AllocatedNum.alloc(cs, v)
    blc = b.lc()
    if pre_add is not None:
        blc = blc + (pre_add, ONE)
    clc = LinearCombination.from_variable(res.get_variable())
    if post_add is not None:
        clc = clc + (-post_add, ONE)
    cs.enforce(blc, LinearCombination.from_variable(a.get_variable()), clc)
    return res


def _square_sum(cs, to_add: int, elt: Elt) -> AllocatedNum:
    p = cs.field.p

    def sq():
        v = elt.val()
        return None if v is None else (v + to_add) * (v + to_add) % p

    res = AllocatedNum.alloc(cs, sq)
    lc_ = elt.lc() + (to_add, ONE)
    cs.enforce(lc_, lc_, LinearCombination.from_variable(res.get_variable()))
    return res


def _quintic_sbox(cs, l: Elt, post_round_key) -> Elt:
    l2 = l.square(cs)
    l4 = Elt.from_allocated(l2).square(cs)
    l5 = _mul_sum(cs, l4, l, None, post_round_key)
    return Elt.from_allocated(l5)


def _quintic_sbox_pre_add(cs, l: Elt, pre_round_key, post_round_key) -> Elt:
    assert pre_round_key is not None and post_round_key is not None
    l2 = _square_sum(cs, pre_round_key, l)
    l4 = Elt.from_allocated(l2).square(cs)
    l5 = _mul_sum(cs, l4, l, pre_round_key, post_round_key)
    return Elt.from_allocated(l5)


def _permutation_witness(consts, in_vals, compact, p):
    """Flat witness evaluator for one Poseidon permutation: returns
    (final_state, alloc_values) where alloc_values lists, in allocation
    order, exactly the values `_hash_inner`'s gadget path allocates (3 per
    quintic sbox, plus the compact-mode ensure_allocated re-allocations).
    The reference ships the same idea for its hot gadget
    (frontend/gadgets/poseidon/circuit2_witness.rs); here it collapses the
    tape's per-node closure chains into one native pass per permutation.
    """
    h = native_ctx(consts)
    if h is not None:
        from nova_tpu_torch import native

        return native.poseidon_permute_witness(
            h, p, list(in_vals), consts.width, consts.full_rounds,
            consts.partial_rounds, compact,
        )
    st = list(in_vals)
    width = len(st)
    allocs = []
    crc = consts.compressed_round_constants
    off = 0
    cur_round = 0
    full_half = consts.half_full_rounds
    sparse_offset = full_half - 1

    def sbox_pre(v, pre, post):
        t = (v + pre) % p
        l2 = t * t % p
        allocs.append(l2)
        l4 = l2 * l2 % p
        allocs.append(l4)
        l5 = (t * l4 + post) % p
        allocs.append(l5)
        return l5

    def sbox(v, post):
        l2 = v * v % p
        allocs.append(l2)
        l4 = l2 * l2 % p
        allocs.append(l4)
        l5 = l4 * v % p
        if post is not None:
            l5 = (l5 + post) % p
        allocs.append(l5)
        return l5

    def product_mds():
        nonlocal st, cur_round
        if cur_round == sparse_offset:
            matrix = consts.pre_sparse_matrix
            st = [
                sum(st[i] * matrix[i][j] for i in range(width)) % p
                for j in range(width)
            ]
        elif sparse_offset < cur_round < full_half + consts.partial_rounds:
            w_hat, v_rest = consts.sparse_matrixes[cur_round - sparse_offset - 1]
            r0 = sum(e * s for e, s in zip(st, w_hat)) % p
            st = [r0] + [
                (st[j] + st[0] * v_rest[j - 1]) % p for j in range(1, width)
            ]
        else:
            matrix = consts.m
            st = [
                sum(st[i] * matrix[i][j] for i in range(width)) % p
                for j in range(width)
            ]
        cur_round += 1

    def full_round(first, last):
        nonlocal off
        pre_keys = crc[off : off + width] if first else []
        off += len(pre_keys)
        post_keys = crc[off : off + width] if (first or not last) else []
        off += len(post_keys)
        for i in range(width):
            if first:
                st[i] = sbox_pre(st[i], pre_keys[i], post_keys[i])
            else:
                st[i] = sbox(st[i], post_keys[i] if post_keys else None)
        product_mds()

    full_round(True, False)
    for _ in range(1, consts.full_rounds // 2):
        full_round(False, False)
    for _ in range(consts.partial_rounds):
        rk = crc[off]
        off += 1
        st[0] = sbox(st[0], rk)
        product_mds()
        if compact:
            allocs.extend(st[1:])
    for _ in range(consts.full_rounds // 2 - 1):
        full_round(False, False)
    full_round(False, True)
    return st, allocs


class PoseidonCircuit:
    """PoseidonCircuit2: the in-circuit optimized-static permutation."""

    def __init__(self, consts: PoseidonConstants, elements: List[Elt], compact: bool = False):
        self.consts = consts
        self.width = consts.width
        self.elements = elements
        self.pos = 1
        self.constants_offset = 0
        self.current_round = 0
        self.compact = compact

    @staticmethod
    def new_empty(consts: PoseidonConstants) -> "PoseidonCircuit":
        return PoseidonCircuit(consts, [Elt.num_from_fr(0) for _ in range(consts.width)])

    def hash(self, cs: ConstraintSystem) -> Elt:
        prev = Elt.VALUE_ONLY
        Elt.VALUE_ONLY = cs.is_witness_generator() and not getattr(
            cs, "records_constraints", False
        )
        try:
            return self._hash_inner(cs)
        finally:
            Elt.VALUE_ONLY = prev

    def _hash_inner(self, cs: ConstraintSystem) -> Elt:
        import os

        if (
            Elt.VALUE_ONLY
            and cs.is_witness_generator()
            and not os.environ.get("NOVA_NO_POSEIDON_FAST")
        ):
            # one flat native pass per permutation; tape entries index
            # into its (epoch-memoized) result instead of chaining
            # per-node closures
            p = cs.field.p
            consts = self.consts
            compact = self.compact
            in_fns = [e.val for e in self.elements]
            plan = _tape.Lazy(
                lambda: _permutation_witness(
                    consts, [f() for f in in_fns], compact, p
                )
            )
            n_allocs = len(plan.get()[1])
            for i in range(n_allocs):
                AllocatedNum.alloc(cs, (lambda i=i: plan.get()[1][i]))
            self.elements = [
                Elt(num=Num(
                    _tape.Lazy(lambda j=j: plan.get()[0][j]),
                    LinearCombination.zero(),
                ))
                for j in range(self.width)
            ]
            elt = self.elements[1]
            self.reset_offsets()
            return elt
        self._full_round(cs, True, False)
        for _ in range(1, self.consts.full_rounds // 2):
            self._full_round(cs, False, False)
        for _ in range(self.consts.partial_rounds):
            self._partial_round(cs)
        for _ in range(self.consts.full_rounds // 2 - 1):
            self._full_round(cs, False, False)
        self._full_round(cs, False, True)
        elt = self.elements[1]
        self.reset_offsets()
        return elt

    def reset_offsets(self):
        self.constants_offset = 0
        self.current_round = 0
        self.pos = 1

    def _full_round(self, cs, first_round: bool, last_round: bool):
        crc = self.consts.compressed_round_constants
        off = self.constants_offset
        pre_keys = crc[off : off + self.width] if first_round else []
        off += len(pre_keys)
        post_keys = crc[off : off + self.width] if (first_round or not last_round) else []
        off += len(post_keys)
        for i in range(self.width):
            if first_round:
                self.elements[i] = _quintic_sbox_pre_add(
                    cs, self.elements[i], pre_keys[i], post_keys[i]
                )
            else:
                pk = post_keys[i] if post_keys else None
                self.elements[i] = _quintic_sbox(cs, self.elements[i], pk)
        self.constants_offset = off
        self._product_mds(cs)

    def _partial_round(self, cs):
        rk = self.consts.compressed_round_constants[self.constants_offset]
        self.constants_offset += 1
        self.elements[0] = _quintic_sbox(cs, self.elements[0], rk)
        self._product_mds(cs)
        if self.compact:
            for i in range(1, self.width):
                self.elements[i] = Elt.from_allocated(self.elements[i].ensure_allocated(cs))

    def _product_mds(self, cs):
        consts = self.consts
        full_half = consts.half_full_rounds
        sparse_offset = full_half - 1
        p = cs.field.p
        if self.current_round == sparse_offset:
            self._product_with_matrix(cs, consts.pre_sparse_matrix)
        elif sparse_offset < self.current_round < full_half + consts.partial_rounds:
            w_hat, v_rest = consts.sparse_matrixes[self.current_round - sparse_offset - 1]
            result = [self._scalar_product(cs, self.elements, w_hat)]
            for j in range(1, self.width):
                result.append(
                    self.elements[j].add(self.elements[0].scale(v_rest[j - 1], p), p)
                )
            self.elements = result
        else:
            self._product_with_matrix(cs, consts.m)
        self.current_round += 1

    def _product_with_matrix(self, cs, matrix):
        result = []
        for j in range(self.width):
            column = [matrix[i][j] for i in range(self.width)]
            result.append(self._scalar_product(cs, self.elements, column))
        self.elements = result

    @staticmethod
    def _scalar_product(cs, elts: List[Elt], scalars: List[int]) -> Elt:
        p = cs.field.p
        if Elt.VALUE_ONLY:
            # witness fast path: plain integer dot product, one Elt out
            if _tape.TRACING:
                def acc_fn():
                    acc = 0
                    for e, s in zip(elts, scalars):
                        acc += e.val() * s
                    return acc % p

                return Elt(num=Num(_tape.Lazy(acc_fn), LinearCombination.zero()))
            acc_v = 0
            for e, s in zip(elts, scalars):
                acc_v += e.val() * s
            return Elt(num=Num(acc_v % p, LinearCombination.zero()))
        acc = Elt(num=Num(0, LinearCombination.zero()))
        for e, s in zip(elts, scalars):
            acc = acc.add(e.scale(s, p), p)
        return acc


class SpongeCircuit:
    """Simplex sponge over the PoseidonCircuit (sponge/circuit.rs), exposing
    the start/absorb/squeeze API of the vanilla sponge."""

    def __init__(self, consts: PoseidonConstants, compact: bool = False):
        self.consts = consts
        self.state = PoseidonCircuit.new_empty(consts)
        self.state.compact = compact
        self.rate = consts.arity
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def start(self, pattern, domain_separator: int = 0):
        tag = io_pattern_value(pattern, domain_separator)
        self.state.elements[0] = Elt.num_from_fr(tag % self.consts.field.p)
        for i in range(self.rate):
            self.state.elements[1 + i] = Elt.num_from_fr(0)
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def _permute(self, cs):
        self.state.hash(cs)
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def absorb(self, cs, elements: List[Elt]):
        p = self.consts.field.p
        for x in elements:
            if self.absorb_pos == self.rate:
                self._permute(cs)
            i = 1 + self.absorb_pos
            self.state.elements[i] = self.state.elements[i].add(x, p)
            self.absorb_pos += 1
        self.squeeze_pos = self.rate

    def squeeze(self, cs, length: int) -> List[Elt]:
        out = []
        for _ in range(length):
            if self.squeeze_pos == self.rate:
                self._permute(cs)
                self.squeeze_pos = 0
                self.absorb_pos = 0
            out.append(self.state.elements[1 + self.squeeze_pos])
            self.squeeze_pos += 1
        return out


def sponge_hash_circuit(cs, consts: PoseidonConstants, inputs: List[Elt], compact=False) -> AllocatedNum:
    """absorb-n/squeeze-1, returning an allocated hash (the
    poseidon_squeeze_circuit! macro, src/provider/poseidon.rs:137-166)."""
    sponge = SpongeCircuit(consts, compact)
    sponge.start([("absorb", len(inputs)), ("squeeze", 1)])
    sponge.absorb(cs, inputs)
    out = sponge.squeeze(cs, 1)[0]
    return out.ensure_allocated(cs)


class PoseidonROCircuit:
    """The in-circuit RO (src/provider/poseidon.rs:127-269)."""

    def __init__(self, constants: PoseidonROConstants, mode: str = "wide", compact: bool = False):
        self.constants = constants
        self.mode = mode
        self.compact = compact
        self.state: List[AllocatedNum] = []

    def absorb(self, e: AllocatedNum):
        self.state.append(e)

    def _consts(self):
        return self.constants.wide if self.mode == "wide" else self.constants.narrow

    def squeeze(self, cs, num_bits: int, start_with_one: bool = False):
        """Returns num_bits little-endian AllocatedBits."""
        from nova_tpu_torch.frontend.boolean import AllocatedBit

        hash_num = sponge_hash_circuit(
            cs, self._consts(), [Elt.from_allocated(e) for e in self.state], self.compact
        )
        self.state = [hash_num]
        bits = hash_num.to_bits_le_strict(cs)
        bits = [b.bit for b in bits[:num_bits]]  # AllocatedBits ('is' kind)
        if start_with_one:
            msb = AllocatedBit.alloc(cs, True)
            cs.enforce(
                LinearCombination.from_variable(msb.get_variable()),
                LinearCombination.from_variable(ONE),
                LinearCombination.from_variable(ONE),
            )
            bits[num_bits - 1] = msb
        return bits

    def squeeze_scalar(self, cs) -> AllocatedNum:
        hash_num = sponge_hash_circuit(
            cs, self._consts(), [Elt.from_allocated(e) for e in self.state], self.compact
        )
        self.state = [hash_num]
        return hash_num
