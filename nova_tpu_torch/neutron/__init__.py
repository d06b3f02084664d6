"""NeutronNova folding (experimental; port of ``nova_tpu/neutron``;
reference: src/neutron/).

Folding via a single sumcheck round over a "zero-fold" relation instead of
cross-terms: the running FoldedInstance carries a sumcheck target T and a
commitment to a tensor-split eq polynomial E = E1 ++ E2 (outer product
E2 x E1 equals the full eq table, src/neutron/relation.rs:50-62). The NIFS
message is a degree-5 univariate + comm_E (src/neutron/nifs.rs:19-24).
Single-curve: the RO is RO2 (Poseidon over the scalar field).

Routes are the JAX package's: vectors are int lists; the SpMV runs on the
commitment key's device at or above DEVICE_THRESHOLD constraints (the
device SpMV), the round polynomial in the native binding from 64 rows, and
the commits by length (``CommitmentEngine.commit``).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from nova_tpu_torch.constants import NUM_CHALLENGE_BITS
from nova_tpu_torch.errors import InvalidSumcheckProofError, UnSatError
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine as CE, CommitmentKey
from nova_tpu_torch.r1cs import R1CSInstance, R1CSShape, R1CSWitness
from nova_tpu_torch.spartan.polys import PowPolynomial, UniPoly, log2_int


class Structure:
    """src/neutron/relation.rs:16-68."""

    def __init__(self, S: R1CSShape):
        S = S.pad()
        self.S = S
        ell = log2_int(S.num_cons)
        ell1 = (ell + 1) // 2
        ell2 = ell // 2
        self.ell = ell
        self.left = 1 << ell1
        self.right = 1 << ell2

    def is_sat(self, ck: CommitmentKey, U: "FoldedInstance", W: "FoldedWitness") -> None:
        field = self.S.field
        p = field.p
        z = list(W.W) + [U.u] + list(U.X)
        Az, Bz, Cz = self.S.multiply_vec(z, ck.device)
        E1, E2 = W.E[: self.left], W.E[self.left:]
        total = 0
        for i in range(self.right):
            e2 = E2[i]
            acc = 0
            for j in range(self.left):
                k = i * self.left + j
                acc += E1[j] * ((Az[k] * Bz[k] - Cz[k]) % p)
            total = (total + e2 * (acc % p)) % p
        if total != U.T % p:
            raise UnSatError("neutron zero-fold sum != T")
        if (
            CE.commit(ck, W.W, W.r_W) != U.comm_W
            or CE.commit(ck, W.E, W.r_E) != U.comm_E
        ):
            raise UnSatError("invalid neutron commitments")


@dataclass
class FoldedWitness:
    W: List[int]
    r_W: int
    E: List[int]
    r_E: int

    @staticmethod
    def default(S: Structure) -> "FoldedWitness":
        return FoldedWitness([0] * S.S.num_vars, 0, [0] * (S.left + S.right), 0)

    def fold(self, field, W2: R1CSWitness, E2: Sequence[int], r_E2: int, r_b: int):
        p = field.p
        W = [(w1 + r_b * (w2 - w1)) % p for w1, w2 in zip(self.W, W2.W)]
        r_W = ((1 - r_b) * self.r_W + r_b * W2.r_W) % p
        E = [(e1 + r_b * (e2 - e1)) % p for e1, e2 in zip(self.E, E2)]
        r_E = ((1 - r_b) * self.r_E + r_b * r_E2) % p
        return FoldedWitness(W, r_W, E, r_E)


@dataclass
class FoldedInstance:
    comm_W: Commitment
    comm_E: Commitment
    T: int
    u: int
    X: List[int]

    @staticmethod
    def default(curve, S: Structure) -> "FoldedInstance":
        return FoldedInstance(
            Commitment.default(curve), Commitment.default(curve), 0, 0,
            [0] * S.S.num_io,
        )

    def fold(self, field, U2: R1CSInstance, comm_E: Commitment, r_b: int, T_out: int):
        p = field.p
        one_m = (1 - r_b) % p
        comm_W = self.comm_W * one_m + U2.comm_W * r_b
        comm_E_new = self.comm_E * one_m + comm_E * r_b
        X = [(one_m * x1 + r_b * x2) % p for x1, x2 in zip(self.X, U2.X)]
        u = (one_m * self.u + r_b) % p
        return FoldedInstance(comm_W, comm_E_new, T_out % p, u, X)

    def absorb_in_ro2(self, ro):
        self.comm_W.absorb_in_ro2(ro)
        self.comm_E.absorb_in_ro2(ro)
        ro.absorb(self.T)
        ro.absorb(self.u)
        for x in self.X:
            ro.absorb(x)


@dataclass
class NIFS:
    """src/neutron/nifs.rs:17-295."""

    comm_E: Commitment
    poly: UniPoly

    @staticmethod
    def _prove_helper(field, rho, left, right, e1, Az1, Bz1, Cz1, e2, Az2, Bz2, Cz2):
        """Evaluations of the round polynomial at {0, 2, 3, 4, 5}
        (nifs.rs:28-186): linear extension between instance 1 (t=0) and
        instance 2 (t=1), weighted by eq(rho, t)."""
        p = field.p
        from nova_tpu_torch import native

        if native.available() and left * right >= 64:
            from nova_tpu_torch.r1cs import _vec_limbs

            sums = native.neutron_round_l(
                p,
                _vec_limbs(e1, p), _vec_limbs(e2, p),
                _vec_limbs(Az1, p), _vec_limbs(Bz1, p), _vec_limbs(Cz1, p),
                _vec_limbs(Az2, p), _vec_limbs(Bz2, p), _vec_limbs(Cz2, p),
                left, right,
            )
            factors = [
                (1 - rho) % p,
                (3 * rho - 1) % p,
                (5 * rho - 2) % p,
                (7 * rho - 3) % p,
                (9 * rho - 4) % p,
            ]
            return [s * f % p for s, f in zip(sums, factors)]
        sums = [0, 0, 0, 0, 0]  # at 0, 2, 3, 4, 5
        f1, f2 = e1[left:], e2[left:]
        for i in range(right):
            inner = [0, 0, 0, 0, 0]
            base = i * left
            for j in range(left):
                k = base + j
                ev, av, bv, cv = e1[j], Az1[k], Bz1[k], Cz1[k]
                de, da = e2[j] - e1[j], Az2[k] - Az1[k]
                db, dc = Bz2[k] - Bz1[k], Cz2[k] - Cz1[k]
                inner[0] += ev * ((av * bv - cv) % p)
                # walk t = 2, 3, 4, 5 incrementally
                ev, av, bv, cv = ev + 2 * de, av + 2 * da, bv + 2 * db, cv + 2 * dc
                inner[1] += ev * ((av * bv - cv) % p)
                for t in range(2, 5):
                    ev, av, bv, cv = ev + de, av + da, bv + db, cv + dc
                    inner[t] += ev * ((av * bv - cv) % p)
            fv = f1[i]
            df = f2[i] - f1[i]
            sums[0] = (sums[0] + fv * inner[0]) % p
            fv = fv + 2 * df
            sums[1] = (sums[1] + fv * inner[1]) % p
            for t in range(2, 5):
                fv = fv + df
                sums[t] = (sums[t] + fv * inner[t]) % p
        # eq(rho, t) factors at t = 0, 2, 3, 4, 5
        factors = [
            (1 - rho) % p,
            (3 * rho - 1) % p,
            (5 * rho - 2) % p,
            (7 * rho - 3) % p,
            (9 * rho - 4) % p,
        ]
        return [s * f % p for s, f in zip(sums, factors)]

    @staticmethod
    def prove(
        ck: CommitmentKey,
        engine,
        pp_digest: int,
        S: Structure,
        U1: FoldedInstance,
        W1: FoldedWitness,
        U2: R1CSInstance,
        W2: R1CSWitness,
        r_E: int = None,
    ) -> Tuple["NIFS", Tuple[FoldedInstance, FoldedWitness]]:
        field = engine.scalar
        p = field.p
        ro = engine.new_ro2()
        ro.absorb(pp_digest)
        U2.absorb_in_ro2(ro)
        tau = ro.squeeze(NUM_CHALLENGE_BITS, False)

        E = PowPolynomial(field, tau, S.ell).split_evals(S.left, S.right)
        if r_E is None:
            r_E = secrets.randbelow(p)
        comm_E = CE.commit(ck, E, r_E)
        comm_E.absorb_in_ro2(ro)
        rho = ro.squeeze(NUM_CHALLENGE_BITS, False)

        T = (1 - rho) * U1.T % p

        z1 = list(W1.W) + [U1.u] + list(U1.X)
        z2 = list(W2.W) + [1] + list(U2.X)
        Az1, Bz1, Cz1 = S.S.multiply_vec(z1, ck.device)
        Az2, Bz2, Cz2 = S.S.multiply_vec(z2, ck.device)

        ev0, ev2, ev3, ev4, ev5 = NIFS._prove_helper(
            field, rho, S.left, S.right, W1.E, Az1, Bz1, Cz1, E, Az2, Bz2, Cz2
        )
        evals = [ev0, (T - ev0) % p, ev2, ev3, ev4, ev5]
        poly = UniPoly.from_evals(field, evals)

        for c in poly.coeffs:
            ro.absorb(c)
        r_b = ro.squeeze(NUM_CHALLENGE_BITS, False)

        eq_rho_rb = ((1 - rho) * (1 - r_b) + rho * r_b) % p
        T_out = poly.evaluate(r_b) * pow(eq_rho_rb, -1, p) % p

        U = U1.fold(field, U2, comm_E, r_b, T_out)
        W = W1.fold(field, W2, E, r_E, r_b)
        return NIFS(comm_E, poly), (U, W)

    def verify(
        self, engine, pp_digest: int, U1: FoldedInstance, U2: R1CSInstance
    ) -> FoldedInstance:
        field = engine.scalar
        p = field.p
        ro = engine.new_ro2()
        ro.absorb(pp_digest)
        U2.absorb_in_ro2(ro)
        ro.squeeze(NUM_CHALLENGE_BITS, False)  # tau
        self.comm_E.absorb_in_ro2(ro)
        rho = ro.squeeze(NUM_CHALLENGE_BITS, False)

        T = (1 - rho) * U1.T % p
        if (self.poly.eval_at_zero() + self.poly.eval_at_one()) % p != T:
            raise InvalidSumcheckProofError()

        for c in self.poly.coeffs:
            ro.absorb(c)
        r_b = ro.squeeze(NUM_CHALLENGE_BITS, False)

        eq_rho_rb = ((1 - rho) * (1 - r_b) + rho * r_b) % p
        T_out = self.poly.evaluate(r_b) * pow(eq_rho_rb, -1, p) % p
        return U1.fold(field, U2, self.comm_E, r_b, T_out)
