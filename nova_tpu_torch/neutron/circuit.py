"""NeutronNova augmented circuit (port of ``nova_tpu/neutron/circuit.py``;
reference: src/neutron/circuit/).

Single-curve: the circuit is over E1::Scalar and treats commitments as
NONNATIVE points (BigNat coordinate limbs); the commitment folds
comm_W_fold/comm_E_fold enter as untrusted hints (the reference marks this
scheme experimental for exactly this reason, src/neutron/mod.rs:2).
Public IO: one value, H(pp, i+1, z0, z_{i+1}, U_new, r_next).

Golden constraint counts (src/neutron/circuit/mod.rs:436-440):
7047 Pallas / 7327 BN254 / 7792 secp256k1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from nova_tpu_torch.constants import BN_LIMB_WIDTH, BN_N_LIMBS, NUM_CHALLENGE_BITS, NUM_HASH_BITS
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem, LinearCombination, ONE, lc
from nova_tpu_torch.frontend.num import AllocatedNum, Num
from nova_tpu_torch.gadgets.bignat import BigNat, conditionally_select_bignat
from nova_tpu_torch.gadgets.poseidon_circuit import PoseidonROCircuit
from nova_tpu_torch.gadgets.utils import (
    alloc_num_equals,
    alloc_zero,
    conditionally_select,
    conditionally_select_vec,
    le_bits_to_num,
    lc_of,
)


class AllocatedNonnativePoint:
    """(x, y) as BigNats + is_infinity num (src/gadgets/ecc.rs:911-1030)."""

    def __init__(self, x: BigNat, y: BigNat, is_infinity: AllocatedNum):
        self.x = x
        self.y = y
        self.is_infinity = is_infinity

    @staticmethod
    def alloc(cs, coords) -> "AllocatedNonnativePoint":
        xv = 0 if coords is None else coords[0]
        yv = 0 if coords is None else coords[1]
        inf = True if coords is None else coords[2]
        x = BigNat.alloc_from_nat(cs, xv, BN_LIMB_WIDTH, BN_N_LIMBS)
        y = BigNat.alloc_from_nat(cs, yv, BN_LIMB_WIDTH, BN_N_LIMBS)
        is_inf = AllocatedNum.alloc(cs, 1 if inf else 0)
        cs.enforce(
            lc_of(is_inf.get_variable()),
            lc((1, ONE)) - is_inf.get_variable(),
            LinearCombination.zero(),
        )
        return AllocatedNonnativePoint(x, y, is_inf)

    @staticmethod
    def default(cs) -> "AllocatedNonnativePoint":
        one = AllocatedNum(ONE, 1)
        zero = BigNat.alloc_constant(cs, 0, BN_LIMB_WIDTH, BN_N_LIMBS)
        return AllocatedNonnativePoint(zero, zero, one)

    def absorb_in_ro(self, cs, ro: PoseidonROCircuit):
        for limb in self.x.as_allocated_nums(cs):
            ro.absorb(limb)
        for limb in self.y.as_allocated_nums(cs):
            ro.absorb(limb)
        ro.absorb(self.is_infinity)

    @staticmethod
    def conditionally_select(cs, a, b, condition: Boolean):
        x = conditionally_select_bignat(cs, a.x, b.x, condition)
        y = conditionally_select_bignat(cs, a.y, b.y, condition)
        is_inf = conditionally_select(cs, a.is_infinity, b.is_infinity, condition)
        return AllocatedNonnativePoint(x, y, is_inf)


class AllocatedUniPoly:
    """src/neutron/circuit/univariate.rs."""

    def __init__(self, coeffs: List[AllocatedNum]):
        self.coeffs = coeffs

    @staticmethod
    def alloc(cs, degree: int, poly) -> "AllocatedUniPoly":
        coeffs = []
        for i in range(degree + 1):
            v = 0 if poly is None else poly.coeffs[i]
            coeffs.append(AllocatedNum.alloc(cs, v))
        return AllocatedUniPoly(coeffs)

    def check_poly_zero_poly_one_with(self, cs, c: AllocatedNum):
        rhs = lc_of(self.coeffs[0].get_variable())
        for v in self.coeffs:
            rhs = rhs + v.get_variable()
        cs.enforce(lc_of(c.get_variable()), lc((1, ONE)), rhs)

    def evaluate(self, cs, r: AllocatedNum) -> AllocatedNum:
        f = cs.field
        acc = self.coeffs[0]
        power = r
        for coeff in self.coeffs[1:]:
            av, pv, cv = acc.get_value(), power.get_value(), coeff.get_value()
            nv = None if None in (av, pv, cv) else (av + pv * cv) % f.p
            acc_new = AllocatedNum.alloc(cs, nv)
            cs.enforce(
                lc_of(power.get_variable()),
                lc_of(coeff.get_variable()),
                lc_of(acc_new.get_variable()) - acc.get_variable(),
            )
            pn = None if None in (pv, r.get_value()) else pv * r.get_value() % f.p
            power_new = AllocatedNum.alloc(cs, pn)
            cs.enforce(
                lc_of(power.get_variable()),
                lc_of(r.get_variable()),
                lc_of(power_new.get_variable()),
            )
            power = power_new
            acc = acc_new
        return acc

    def absorb_in_ro(self, ro: PoseidonROCircuit):
        for coeff in self.coeffs:
            ro.absorb(coeff)


class AllocatedNonnativeR1CSInstance:
    """src/neutron/circuit/r1cs.rs."""

    def __init__(self, comm_W: AllocatedNonnativePoint, X: AllocatedNum):
        self.comm_W = comm_W
        self.X = X

    @staticmethod
    def alloc(cs, u) -> "AllocatedNonnativeR1CSInstance":
        comm_W = AllocatedNonnativePoint.alloc(
            cs, None if u is None else u.comm_W.to_coordinates()
        )
        X = AllocatedNum.alloc(cs, 0 if u is None else u.X[0])
        return AllocatedNonnativeR1CSInstance(comm_W, X)

    def absorb_in_ro(self, cs, ro: PoseidonROCircuit):
        self.comm_W.absorb_in_ro(cs, ro)
        ro.absorb(self.X)


class AllocatedFoldedInstance:
    """src/neutron/circuit/relation.rs."""

    def __init__(self, comm_W, comm_E, T, u, X):
        self.comm_W = comm_W
        self.comm_E = comm_E
        self.T = T
        self.u = u
        self.X = X

    @staticmethod
    def alloc(cs, inst) -> "AllocatedFoldedInstance":
        comm_W = AllocatedNonnativePoint.alloc(
            cs, None if inst is None else inst.comm_W.to_coordinates()
        )
        comm_E = AllocatedNonnativePoint.alloc(
            cs, None if inst is None else inst.comm_E.to_coordinates()
        )
        T = AllocatedNum.alloc(cs, 0 if inst is None else inst.T)
        u = AllocatedNum.alloc(cs, 0 if inst is None else inst.u)
        X = AllocatedNum.alloc(cs, 0 if inst is None else inst.X[0])
        return AllocatedFoldedInstance(comm_W, comm_E, T, u, X)

    @staticmethod
    def default(cs) -> "AllocatedFoldedInstance":
        comm_W = AllocatedNonnativePoint.default(cs)
        comm_E = comm_W
        T = alloc_zero(cs)
        return AllocatedFoldedInstance(comm_W, comm_E, T, T, T)

    def absorb_in_ro(self, cs, ro: PoseidonROCircuit):
        self.comm_W.absorb_in_ro(cs, ro)
        self.comm_E.absorb_in_ro(cs, ro)
        ro.absorb(self.T)
        ro.absorb(self.u)
        ro.absorb(self.X)

    def fold(self, cs, U2, r_b, T_out, comm_W_fold, comm_E_fold):
        f = cs.field
        uv, rv = self.u.get_value(), r_b.get_value()
        u_fold_v = None if None in (uv, rv) else (uv + rv * (1 - uv)) % f.p
        u_fold = AllocatedNum.alloc(cs, u_fold_v)
        cs.enforce(
            lc_of(r_b.get_variable()),
            lc((1, ONE)) - self.u.get_variable(),
            lc_of(u_fold.get_variable()) - self.u.get_variable(),
        )

        Xv, X2v = self.X.get_value(), U2.X.get_value()
        X_fold_v = None if None in (Xv, rv, X2v) else (Xv + rv * (X2v - Xv)) % f.p
        X_fold = AllocatedNum.alloc(cs, X_fold_v)
        cs.enforce(
            lc_of(r_b.get_variable()),
            lc_of(U2.X.get_variable()) - self.X.get_variable(),
            lc_of(X_fold.get_variable()) - self.X.get_variable(),
        )
        return AllocatedFoldedInstance(comm_W_fold, comm_E_fold, T_out, u_fold, X_fold)

    def conditionally_select(self, cs, other, condition: Boolean):
        comm_W = AllocatedNonnativePoint.conditionally_select(
            cs, self.comm_W, other.comm_W, condition
        )
        comm_E = AllocatedNonnativePoint.conditionally_select(
            cs, self.comm_E, other.comm_E, condition
        )
        T = conditionally_select(cs, self.T, other.T, condition)
        u = conditionally_select(cs, self.u, other.u, condition)
        X = conditionally_select(cs, self.X, other.X, condition)
        return AllocatedFoldedInstance(comm_W, comm_E, T, u, X)


class AllocatedNIFS:
    """src/neutron/circuit/nifs.rs."""

    def __init__(self, comm_E: AllocatedNonnativePoint, poly: AllocatedUniPoly):
        self.comm_E = comm_E
        self.poly = poly

    @staticmethod
    def alloc(cs, nifs, degree: int) -> "AllocatedNIFS":
        comm_E = AllocatedNonnativePoint.alloc(
            cs, None if nifs is None else nifs.comm_E.to_coordinates()
        )
        poly = AllocatedUniPoly.alloc(cs, degree, None if nifs is None else nifs.poly)
        return AllocatedNIFS(comm_E, poly)

    def verify(self, cs, pp_digest, U1, U2, comm_W_fold, comm_E_fold, ro_consts):
        f = cs.field
        ro = PoseidonROCircuit(ro_consts)
        ro.absorb(pp_digest)
        U2.absorb_in_ro(cs, ro)
        ro.squeeze(cs, NUM_CHALLENGE_BITS, False)  # tau
        self.comm_E.absorb_in_ro(cs, ro)
        rho_bits = ro.squeeze(cs, NUM_CHALLENGE_BITS, False)
        rho = le_bits_to_num(cs, rho_bits)

        rv, Tv = rho.get_value(), U1.T.get_value()
        T_v = None if None in (rv, Tv) else Tv * (1 - rv) % f.p
        T = AllocatedNum.alloc(cs, T_v)
        cs.enforce(
            lc_of(U1.T.get_variable()),
            lc((1, ONE)) - rho.get_variable(),
            lc_of(T.get_variable()),
        )

        self.poly.check_poly_zero_poly_one_with(cs, T)
        self.poly.absorb_in_ro(ro)
        r_b_bits = ro.squeeze(cs, NUM_CHALLENGE_BITS, False)
        r_b = le_bits_to_num(cs, r_b_bits)

        rbv = r_b.get_value()
        one_v = None if None in (rv, rbv) else (1 - rv) * (1 - rbv) % f.p
        eq_one = AllocatedNum.alloc(cs, one_v)
        cs.enforce(
            lc((1, ONE)) - rho.get_variable(),
            lc((1, ONE)) - r_b.get_variable(),
            lc_of(eq_one.get_variable()),
        )
        eq_v = None if None in (rv, rbv) else ((1 - rv) * (1 - rbv) + rv * rbv) % f.p
        eq_rho_r_b = AllocatedNum.alloc(cs, eq_v)
        cs.enforce(
            lc_of(rho.get_variable()),
            lc_of(r_b.get_variable()),
            lc_of(eq_rho_r_b.get_variable()) - eq_one.get_variable(),
        )

        ev = self.poly.evaluate(cs, r_b)
        evv, eqv = ev.get_value(), eq_rho_r_b.get_value()
        T_out_v = None
        if evv is not None and eqv is not None:
            T_out_v = evv * pow(eqv, -1, f.p) % f.p
        T_out = AllocatedNum.alloc(cs, T_out_v)
        cs.enforce(
            lc_of(T_out.get_variable()),
            lc_of(eq_rho_r_b.get_variable()),
            lc_of(ev.get_variable()),
        )

        return U1.fold(cs, U2, r_b, T_out, comm_W_fold, comm_E_fold)


@dataclass
class NeutronAugmentedCircuitInputs:
    pp_digest: int
    i: int
    z0: List[int]
    zi: Optional[List[int]] = None
    U: Optional[object] = None
    ri: Optional[int] = None
    r_next: int = 0
    u: Optional[object] = None
    nifs: Optional[object] = None
    comm_W_fold: Optional[object] = None
    comm_E_fold: Optional[object] = None


class NeutronAugmentedCircuit:
    """src/neutron/circuit/mod.rs:86-380."""

    def __init__(self, inputs, step_circuit, ro_consts):
        self.inputs = inputs
        self.step_circuit = step_circuit
        self.ro_consts = ro_consts

    def _alloc_witness(self, cs, arity):
        inp = self.inputs
        pp_digest = AllocatedNum.alloc(cs, None if inp is None else inp.pp_digest)
        i = AllocatedNum.alloc(cs, None if inp is None else inp.i)
        z_0 = [AllocatedNum.alloc(cs, None if inp is None else inp.z0[j]) for j in range(arity)]
        zi_vals = None
        if inp is not None:
            zi_vals = inp.zi if inp.zi is not None else [0] * arity
        z_i = [
            AllocatedNum.alloc(cs, None if zi_vals is None else zi_vals[j])
            for j in range(arity)
        ]
        U = AllocatedFoldedInstance.alloc(cs, None if inp is None else inp.U)
        r_i = AllocatedNum.alloc(
            cs, None if inp is None else (inp.ri if inp.ri is not None else 0)
        )
        r_next = AllocatedNum.alloc(cs, None if inp is None else inp.r_next)
        u = AllocatedNonnativeR1CSInstance.alloc(cs, None if inp is None else inp.u)
        nifs = AllocatedNIFS.alloc(cs, None if inp is None else inp.nifs, 5)
        comm_W_fold = AllocatedNonnativePoint.alloc(
            cs,
            None if (inp is None or inp.comm_W_fold is None)
            else inp.comm_W_fold.to_coordinates(),
        )
        comm_E_fold = AllocatedNonnativePoint.alloc(
            cs,
            None if (inp is None or inp.comm_E_fold is None)
            else inp.comm_E_fold.to_coordinates(),
        )
        return pp_digest, i, z_0, z_i, U, r_i, r_next, u, nifs, comm_W_fold, comm_E_fold

    def synthesize(self, cs: ConstraintSystem) -> List[AllocatedNum]:
        arity = self.step_circuit.arity()
        (pp_digest, i, z_0, z_i, U, r_i, r_next, u, nifs,
         comm_W_fold, comm_E_fold) = self._alloc_witness(cs, arity)

        zero = alloc_zero(cs)
        is_base_case = alloc_num_equals(cs, i, zero)

        Unew_base = AllocatedFoldedInstance.default(cs)

        # non-base case: hash check + in-circuit NIFS
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
        hash_in = le_bits_to_num(cs, hash_bits)
        check_non_base_pass = alloc_num_equals(cs, u.X, hash_in)

        Unew_non_base = nifs.verify(
            cs, pp_digest, U, u, comm_W_fold, comm_E_fold, self.ro_consts
        )

        should_be_false = AllocatedBit.nor(cs, check_non_base_pass, is_base_case)
        cs.enforce(
            lc_of(should_be_false.get_variable()),
            lc((1, ONE)),
            LinearCombination.zero(),
        )

        Unew = Unew_base.conditionally_select(
            cs, Unew_non_base, Boolean.from_bit(is_base_case)
        )

        f = cs.field
        i_new_val = None if i.get_value() is None else f.add(i.get_value(), 1)
        i_new = AllocatedNum.alloc(cs, i_new_val)
        cs.enforce(
            LinearCombination.zero(),
            LinearCombination.zero(),
            lc_of(i_new.get_variable()) - (1, ONE) - i.get_variable(),
        )

        z_input = conditionally_select_vec(cs, z_0, z_i, Boolean.from_bit(is_base_case))
        z_next = self.step_circuit.synthesize(cs, z_input)
        assert len(z_next) == arity

        ro = PoseidonROCircuit(self.ro_consts)
        ro.absorb(pp_digest)
        ro.absorb(i_new)
        for e in z_0:
            ro.absorb(e)
        for e in z_next:
            ro.absorb(e)
        Unew.absorb_in_ro(cs, ro)
        ro.absorb(r_next)
        hash_bits = ro.squeeze(cs, NUM_HASH_BITS, False)
        hash_out = le_bits_to_num(cs, hash_bits)
        hash_out.inputize(cs)
        return z_next
