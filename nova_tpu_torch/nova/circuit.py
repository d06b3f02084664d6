"""The Nova augmented circuit F' (reference: src/nova/circuit/mod.rs +
circuit/r1cs.rs).

Each step synthesizes F' = (in-circuit NIFS verifier for the OTHER curve's
instances) + (the user's step circuit F). The circuit is defined over
engine.base (the base field of the curve whose points it manipulates =
the scalar field of the cycle partner where the constraint system lives).

Public IO: exactly two values [u.X1, H(pp, i+1, z0, z_{i+1}, U_new, r_next)]
(src/nova/circuit/mod.rs:350-353)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from nova_tpu_torch.constants import BN_LIMB_WIDTH, BN_N_LIMBS, NUM_CHALLENGE_BITS, NUM_HASH_BITS
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE
from nova_tpu_torch.frontend.num import AllocatedNum, Num
from nova_tpu_torch.gadgets.bignat import BigNat, conditionally_select_bignat
from nova_tpu_torch.gadgets.ecc import AllocatedPoint
from nova_tpu_torch.gadgets.poseidon_circuit import PoseidonROCircuit
from nova_tpu_torch.gadgets.utils import (
    alloc_num_equals,
    alloc_scalar_as_base,
    alloc_zero,
    conditionally_select,
    conditionally_select_vec,
    lc_of,
    le_bits_to_num,
)
from nova_tpu_torch.provider.engines import Engine


class StepCircuit:
    """User step circuit trait (reference src/traits/circuit.rs:7-21).

    Tape discipline (frontend/tape.py): prove_step compiles the augmented
    circuit (including this circuit) into a replayable witness tape. For
    that to be sound, `synthesize` must pass every allocation value as a
    CLOSURE that reads `self.<state>` or previously allocated wrappers at
    call time — never an int computed in the function body — and the
    constraint/allocation structure must not depend on step values.
    Per-step nondeterministic advice goes in instance attributes; the
    prover copies the current step's attributes onto the traced circuit
    before each replay. Circuits that cannot follow this discipline set
    `tape_safe = False` to get the interpreted synthesis path."""

    tape_safe = True

    def arity(self) -> int:
        raise NotImplementedError

    def synthesize(self, cs: ConstraintSystem, z: List[AllocatedNum]) -> List[AllocatedNum]:
        raise NotImplementedError


class TrivialCircuit(StepCircuit):
    """z_{i+1} = z_i (reference src/traits/circuit.rs TrivialCircuit)."""

    def arity(self) -> int:
        return 1

    def synthesize(self, cs, z):
        return list(z)


class NonTrivialCircuit(StepCircuit):
    """Repeated squaring, `num_cons` constraints per step
    (src/traits/circuit.rs:45-78)."""

    def __init__(self, num_cons: int):
        self.num_cons = num_cons

    def arity(self) -> int:
        return 1

    def synthesize(self, cs, z):
        x = z[0]
        y = x
        for _ in range(self.num_cons):
            y = x.square(cs)
            x = y
        return [y]


# ---------------------------------------------------------------------------
# allocated instance gadgets (circuit/r1cs.rs)
# ---------------------------------------------------------------------------

class AllocatedR1CSInstance:
    def __init__(self, comm_W: AllocatedPoint, X0: AllocatedNum, X1: AllocatedNum):
        self.comm_W = comm_W
        self.X0 = X0
        self.X1 = X1

    @staticmethod
    def alloc(cs, engine: Engine, u) -> "AllocatedR1CSInstance":
        """`u` is an R1CSInstance, None, or a closure returning either
        (tape mode re-reads it on every replay)."""
        ufn = u if callable(u) else (lambda: u)
        comm_W = AllocatedPoint.alloc(
            cs,
            engine.curve,
            lambda: (lambda ui: None if ui is None else ui.comm_W.to_coordinates())(ufn()),
        )
        comm_W.check_on_curve(cs)
        X0 = alloc_scalar_as_base(cs, lambda: (lambda ui: None if ui is None else ui.X[0])(ufn()))
        X1 = alloc_scalar_as_base(cs, lambda: (lambda ui: None if ui is None else ui.X[1])(ufn()))
        return AllocatedR1CSInstance(comm_W, X0, X1)

    def absorb_in_ro(self, ro: PoseidonROCircuit):
        self.comm_W.absorb_in_ro(ro)
        ro.absorb(self.X0)
        ro.absorb(self.X1)


class AllocatedRelaxedR1CSInstance:
    def __init__(self, W, E, u, X0: BigNat, X1: BigNat):
        self.W = W
        self.E = E
        self.u = u
        self.X0 = X0
        self.X1 = X1

    @staticmethod
    def alloc(cs, engine: Engine, inst) -> "AllocatedRelaxedR1CSInstance":
        """`inst` is a RelaxedR1CSInstance, None, or a closure returning
        either (tape mode re-reads it on every replay)."""
        ifn = inst if callable(inst) else (lambda: inst)
        W = AllocatedPoint.alloc(
            cs,
            engine.curve,
            lambda: (lambda U: None if U is None else U.comm_W.to_coordinates())(ifn()),
        )
        E = AllocatedPoint.alloc(
            cs,
            engine.curve,
            lambda: (lambda U: None if U is None else U.comm_E.to_coordinates())(ifn()),
        )
        u = alloc_scalar_as_base(cs, lambda: (lambda U: None if U is None else U.u)(ifn()))
        X0 = BigNat.alloc_from_nat(
            cs, lambda: (lambda U: 0 if U is None else U.X[0])(ifn()), BN_LIMB_WIDTH, BN_N_LIMBS
        )
        X1 = BigNat.alloc_from_nat(
            cs, lambda: (lambda U: 0 if U is None else U.X[1])(ifn()), BN_LIMB_WIDTH, BN_N_LIMBS
        )
        return AllocatedRelaxedR1CSInstance(W, E, u, X0, X1)

    @staticmethod
    def default(cs, engine: Engine) -> "AllocatedRelaxedR1CSInstance":
        W = AllocatedPoint.default(cs, engine.curve)
        E = AllocatedPoint(engine.curve, W.x, W.y, W.is_infinity)
        u = W.x  # zero
        X0 = BigNat.alloc_from_nat(cs, 0, BN_LIMB_WIDTH, BN_N_LIMBS)
        X1 = BigNat.alloc_from_nat(cs, 0, BN_LIMB_WIDTH, BN_N_LIMBS)
        return AllocatedRelaxedR1CSInstance(W, E, u, X0, X1)

    @staticmethod
    def from_r1cs_instance(cs, engine: Engine, inst: AllocatedR1CSInstance):
        E = AllocatedPoint.default(cs, engine.curve)
        u = AllocatedNum(ONE, 1)
        X0 = BigNat.from_num(cs, Num.from_allocated(inst.X0), BN_LIMB_WIDTH, BN_N_LIMBS)
        X1 = BigNat.from_num(cs, Num.from_allocated(inst.X1), BN_LIMB_WIDTH, BN_N_LIMBS)
        return AllocatedRelaxedR1CSInstance(inst.comm_W, E, u, X0, X1)

    def absorb_in_ro(self, cs, ro: PoseidonROCircuit):
        self.W.absorb_in_ro(ro)
        self.E.absorb_in_ro(ro)
        ro.absorb(self.u)
        for limb in self.X0.as_allocated_nums(cs):
            ro.absorb(limb)
        for limb in self.X1.as_allocated_nums(cs):
            ro.absorb(limb)

    def fold_with_r1cs(
        self,
        cs,
        engine: Engine,
        params: AllocatedNum,
        u: AllocatedR1CSInstance,
        T: AllocatedPoint,
        ro_consts,
    ) -> "AllocatedRelaxedR1CSInstance":
        """In-circuit NIFS.verify (circuit/r1cs.rs:215-307)."""
        f = cs.field
        ro = PoseidonROCircuit(ro_consts)
        ro.absorb(params)
        u.absorb_in_ro(ro)
        T.absorb_in_ro(ro)
        r_bits = ro.squeeze(cs, NUM_CHALLENGE_BITS, False)
        r = le_bits_to_num(cs, r_bits)

        rW = u.comm_W.scalar_mul(cs, r_bits)
        W_fold = self.W.add(cs, rW)
        rT = T.scalar_mul(cs, r_bits)
        E_fold = self.E.add(cs, rT)

        def u_val():
            if self.u.get_value() is None or r.get_value() is None:
                return None
            return f.add(self.u.get_value(), r.get_value())

        u_fold = AllocatedNum.alloc(cs, u_val)
        cs.enforce(
            LinearCombination.zero(),
            LinearCombination.zero(),
            lc_of(u_fold.get_variable()) - self.u.get_variable() - r.get_variable(),
        )

        r_bn = BigNat.from_num(cs, Num.from_allocated(r), BN_LIMB_WIDTH, BN_N_LIMBS)
        m_bn = BigNat.alloc_constant(cs, engine.scalar.p, BN_LIMB_WIDTH, BN_N_LIMBS)

        X0_bn = BigNat.from_num(cs, Num.from_allocated(u.X0), BN_LIMB_WIDTH, BN_N_LIMBS)
        _, r_0 = X0_bn.mult_mod(cs, r_bn, m_bn)
        X0_fold = self.X0.add(r_0).red_mod(cs, m_bn)

        X1_bn = BigNat.from_num(cs, Num.from_allocated(u.X1), BN_LIMB_WIDTH, BN_N_LIMBS)
        _, r_1 = X1_bn.mult_mod(cs, r_bn, m_bn)
        X1_fold = self.X1.add(r_1).red_mod(cs, m_bn)

        return AllocatedRelaxedR1CSInstance(W_fold, E_fold, u_fold, X0_fold, X1_fold)

    def conditionally_select(self, cs, other, condition: Boolean):
        W = AllocatedPoint.conditionally_select_point(cs, self.W, other.W, condition)
        E = AllocatedPoint.conditionally_select_point(cs, self.E, other.E, condition)
        u = conditionally_select(cs, self.u, other.u, condition)
        X0 = conditionally_select_bignat(cs, self.X0, other.X0, condition)
        X1 = conditionally_select_bignat(cs, self.X1, other.X1, condition)
        return AllocatedRelaxedR1CSInstance(W, E, u, X0, X1)


# ---------------------------------------------------------------------------
# the augmented circuit
# ---------------------------------------------------------------------------

@dataclass
class NovaAugmentedCircuitInputs:
    pp_digest: int  # E::Scalar
    i: int  # E::Base
    z0: List[int]
    zi: Optional[List[int]] = None
    U: Optional[object] = None  # RelaxedR1CSInstance (of the other curve's shape)
    ri: Optional[int] = None
    r_next: int = 0
    u: Optional[object] = None  # R1CSInstance
    T: Optional[object] = None  # Commitment


class NovaAugmentedCircuit:
    """F' over `engine` (points of engine.curve, CS over engine.base)."""

    def __init__(self, engine: Engine, is_primary_circuit: bool, inputs, step_circuit, ro_consts):
        self.engine = engine
        self.is_primary_circuit = is_primary_circuit
        self.inputs = inputs
        self.step_circuit = step_circuit
        self.ro_consts = ro_consts

    def _alloc_witness(self, cs, arity):
        """All values are closures over `self.inputs` so a recorded tape
        replays with fresh per-step inputs (self.inputs reassigned)."""
        shape_mode = self.inputs is None and not cs.is_witness_generator()
        getp = lambda name: (  # noqa: E731
            lambda: None if self.inputs is None else getattr(self.inputs, name)
        )
        pp_digest = alloc_scalar_as_base(cs, getp("pp_digest"))
        i = AllocatedNum.alloc(cs, None if shape_mode else getp("i"))
        z_0 = [
            AllocatedNum.alloc(
                cs,
                None if shape_mode else (lambda j=j: self.inputs.z0[j]),
            )
            for j in range(arity)
        ]
        z_i = [
            AllocatedNum.alloc(
                cs,
                None
                if shape_mode
                else (
                    lambda j=j: 0 if self.inputs.zi is None else self.inputs.zi[j]
                ),
            )
            for j in range(arity)
        ]
        U = AllocatedRelaxedR1CSInstance.alloc(
            cs, self.engine, lambda: None if self.inputs is None else self.inputs.U
        )
        r_i = AllocatedNum.alloc(
            cs,
            None
            if shape_mode
            else (lambda: self.inputs.ri if self.inputs.ri is not None else 0),
        )
        r_next = AllocatedNum.alloc(cs, None if shape_mode else getp("r_next"))
        u = AllocatedR1CSInstance.alloc(
            cs, self.engine, lambda: None if self.inputs is None else self.inputs.u
        )
        T = AllocatedPoint.alloc(
            cs,
            self.engine.curve,
            lambda: None
            if (self.inputs is None or self.inputs.T is None)
            else self.inputs.T.to_coordinates(),
        )
        T.check_on_curve(cs)
        return pp_digest, i, z_0, z_i, U, r_i, r_next, u, T

    def _hash_check(self, cs, pp_digest, i, z_0, z_i, U, r_i) -> AllocatedNum:
        ro = PoseidonROCircuit(self.ro_consts)
        ro.absorb(pp_digest)
        ro.absorb(i)
        for e in z_0:
            ro.absorb(e)
        for e in z_i:
            ro.absorb(e)
        U.absorb_in_ro(cs, ro)
        ro.absorb(r_i)
        hash_bits = ro.squeeze(cs, NUM_HASH_BITS, False)
        return le_bits_to_num(cs, hash_bits)

    def synthesize(self, cs: ConstraintSystem) -> List[AllocatedNum]:
        arity = self.step_circuit.arity()
        pp_digest, i, z_0, z_i, U, r_i, r_next, u, T = self._alloc_witness(cs, arity)

        zero = alloc_zero(cs)
        is_base_case = alloc_num_equals(cs, i, zero)

        hash_in = self._hash_check(cs, pp_digest, i, z_0, z_i, U, r_i)
        check_non_base_pass = alloc_num_equals(cs, u.X0, hash_in)

        # base case
        if self.is_primary_circuit:
            Unew_base = AllocatedRelaxedR1CSInstance.default(cs, self.engine)
        else:
            Unew_base = AllocatedRelaxedR1CSInstance.from_r1cs_instance(cs, self.engine, u)

        # non-base case: in-circuit fold
        Unew_non_base = U.fold_with_r1cs(cs, self.engine, pp_digest, u, T, self.ro_consts)

        # check_non_base_pass OR base_case
        should_be_false = AllocatedBit.nor(cs, check_non_base_pass, is_base_case)
        cs.enforce(
            lc_of(should_be_false.get_variable()),
            lc_of(ONE),
            LinearCombination.zero(),
        )

        Unew = Unew_base.conditionally_select(
            cs, Unew_non_base, Boolean.from_bit(is_base_case)
        )

        f = cs.field

        def i_new_val():
            return None if i.get_value() is None else f.add(i.get_value(), 1)

        i_new = AllocatedNum.alloc(cs, i_new_val)
        cs.enforce(
            LinearCombination.zero(),
            LinearCombination.zero(),
            lc_of(i_new.get_variable()) - (1, ONE) - i.get_variable(),
        )

        z_input = conditionally_select_vec(cs, z_0, z_i, Boolean.from_bit(is_base_case))
        z_next = self.step_circuit.synthesize(cs, z_input)
        assert len(z_next) == arity

        hash_out = self._hash_check(cs, pp_digest, i_new, z_0, z_next, Unew, r_next)

        u.X1.inputize(cs)
        hash_out.inputize(cs)
        return z_next
