"""Sumcheck protocol (port of ``nova_tpu/spartan/sumcheck.py``; reference:
src/spartan/sumcheck.rs).

Round polynomials are interpolated from {P(0), P(1), leading coeff, P(-1)}.
Each prover has a native round loop (limb tables in the C++ kernels,
``nova_tpu_torch.native``) and a pure-Python one; both give the same
transcript. The device outer sumcheck is ``nova_tpu_torch.ops.sumcheck``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from nova_tpu_torch import native
from nova_tpu_torch.errors import InvalidSumcheckProofError
from nova_tpu_torch.fields.spec import FieldSpec
from nova_tpu_torch.spartan.polys import (
    CompressedUniPoly,
    EqPolynomial,
    MultilinearPolynomial,
    UniPoly,
)

# tables shorter than this take the pure-Python round loops
NATIVE_MIN = 32


class SumcheckProof:
    """A list of compressed round polynomials (src/spartan/sumcheck.rs:43)."""

    def __init__(self, compressed_polys: List[CompressedUniPoly]):
        self.compressed_polys = compressed_polys

    # -- verification --------------------------------------------------------

    def verify(
        self, field: FieldSpec, claim: int, num_rounds: int, degree_bound: int, transcript
    ) -> Tuple[int, List[int]]:
        e = claim % field.p
        r: List[int] = []
        if len(self.compressed_polys) != num_rounds:
            raise InvalidSumcheckProofError()
        for cp in self.compressed_polys:
            poly = cp.decompress(e)
            if poly.degree() > degree_bound:
                raise InvalidSumcheckProofError()
            transcript.absorb(b"p", poly)
            r_i = transcript.squeeze(b"c")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r

    def verify_batch(
        self,
        field: FieldSpec,
        claims: Sequence[int],
        num_rounds: Sequence[int],
        coeffs: Sequence[int],
        degree_bound: int,
        transcript,
    ) -> Tuple[int, List[int]]:
        """Batched verify: claims scaled by 2^{n-n_i} for padding
        (src/spartan/sumcheck.rs:131-162)."""
        assert len(num_rounds) == len(claims) == len(coeffs)
        p = field.p
        nr_max = max(num_rounds)
        claim = 0
        for c, nr, co in zip(claims, num_rounds, coeffs):
            claim = (claim + c * pow(2, nr_max - nr, p) % p * co) % p
        return self.verify(field, claim, nr_max, degree_bound, transcript)

    @staticmethod
    def update_claim(field: FieldSpec, claim: int, evals: Sequence[int], r: int) -> int:
        """evals = [P(0), cubic_coeff, P(-1)]; Horner-evaluate at r
        (src/spartan/sumcheck.rs:69-77)."""
        p = field.p
        e0, c3, em1 = evals[0] % p, evals[1] % p, evals[2] % p
        e1 = (claim - e0) % p
        half = field.inv(2)
        a1 = ((e1 - em1) * half - c3) % p
        a2 = ((e1 + em1) * half - e0) % p
        return (e0 + r * (a1 + r * (a2 + r * c3))) % p

    # -- provers --------------------------------------------------------------

    @staticmethod
    def _round(field, polys, transcript, claim_per_round, evals, deg3: bool):
        """Absorb one round's polynomial, squeeze its challenge; returns
        (r_i, next claim)."""
        p = field.p
        e0 = evals[0]
        if deg3:
            poly = UniPoly.from_evals_deg3(
                field, [e0, (claim_per_round - e0) % p, evals[1], evals[2]])
        else:
            poly = UniPoly.from_evals_deg2(field, [e0, (claim_per_round - e0) % p, evals[1]])
        transcript.absorb(b"p", poly)
        r_i = transcript.squeeze(b"c")
        polys.append(poly.compress())
        return r_i, poly.evaluate(r_i)

    @staticmethod
    def prove_quad_prod(
        field: FieldSpec,
        claim: int,
        num_rounds: int,
        poly_A: MultilinearPolynomial,
        poly_B: MultilinearPolynomial,
        transcript,
    ) -> Tuple["SumcheckProof", List[int], List[int]]:
        """sum_x A(x)*B(x) (src/spartan/sumcheck.rs:189-244)."""
        p = field.p
        r: List[int] = []
        polys: List[CompressedUniPoly] = []
        claim_per_round = claim % p
        if native.available() and len(poly_A) >= NATIVE_MIN:
            Al, Bl = poly_A.to_limbs(), poly_B.to_limbs()
            for _ in range(num_rounds):
                evals = native.sumcheck_quad_round_l(p, Al, Bl)
                r_i, claim_per_round = SumcheckProof._round(
                    field, polys, transcript, claim_per_round, evals, False)
                r.append(r_i)
                Al = native.vec_bind_l(p, Al, r_i)
                Bl = native.vec_bind_l(p, Bl, r_i)
            ca, cb = native.limbs_to_ints(Al)[0], native.limbs_to_ints(Bl)[0]
            poly_A.Z, poly_A.num_vars = [ca], 0
            poly_B.Z, poly_B.num_vars = [cb], 0
            return SumcheckProof(polys), r, [ca, cb]
        for _ in range(num_rounds):
            half = len(poly_A) // 2
            AZ, BZ = poly_A.Z, poly_B.Z
            e0 = sum(AZ[i] * BZ[i] for i in range(half)) % p
            coeff = sum((AZ[half + i] - AZ[i]) * (BZ[half + i] - BZ[i])
                        for i in range(half)) % p
            r_i, claim_per_round = SumcheckProof._round(
                field, polys, transcript, claim_per_round, (e0, coeff), False)
            r.append(r_i)
            poly_A.bind_poly_var_top(r_i)
            poly_B.bind_poly_var_top(r_i)
        return SumcheckProof(polys), r, [poly_A.Z[0], poly_B.Z[0]]

    @staticmethod
    def prove_cubic_with_three_inputs(
        field: FieldSpec,
        claim: int,
        taus: Sequence[int],
        poly_A: MultilinearPolynomial,
        poly_B: MultilinearPolynomial,
        poly_C: MultilinearPolynomial,
        transcript,
    ) -> Tuple["SumcheckProof", List[int], List[int]]:
        """sum_x eq(tau,x) * (A(x)*B(x) - C(x)) = claim
        (src/spartan/sumcheck.rs:445-506). With the native binding the eq
        table is never bound when no tau is 0 or 1 (the Gruen eq-factored
        rounds of src/spartan/sumcheck.rs:580-760) unless NOVA_NO_GRUEN=1,
        else it is bound alongside the tables; all three loops give the same
        proof."""
        p = field.p
        num_rounds = len(taus)
        taus_r = [t % p for t in taus]
        r: List[int] = []
        polys: List[CompressedUniPoly] = []
        claim_per_round = claim % p
        if native.available() and len(poly_A) >= NATIVE_MIN:
            Al, Bl, Cl = poly_A.to_limbs(), poly_B.to_limbs(), poly_C.to_limbs()
            El = native.eq_evals_l(p, taus_r)
            gruen = (all(t not in (0, 1) for t in taus_r)
                     and int(os.environ.get("NOVA_NO_GRUEN", "0")) == 0)
            pre = 1  # eq(tau_{<j}, r_{<j})
            D = 1    # prod_{i<=j} (1 - tau_i)
            for j in range(num_rounds):
                if gruen:
                    # t(0) and the leading coefficient from the unbound eq
                    # prefix, t(1) from the running claim, and the linear eq
                    # factor of round j applied analytically
                    tau = taus_r[j]
                    D = D * (1 - tau) % p
                    g = pre * field.inv(D) % p
                    half = Al.shape[0] // 2
                    t0, tinf = native.sumcheck_cubic_gruen_round_l(
                        p, El[:half], Al, Bl, Cl)
                    lin0 = (1 - tau) % p
                    t1 = (claim_per_round * field.inv(g) - lin0 * t0) * field.inv(tau) % p
                    a1 = (t1 - t0 - tinf) % p
                    tm1 = (t0 - a1 + tinf) % p
                    evals = (g * lin0 % p * t0 % p, g * (2 * tau - 1) % p * tinf % p,
                             g * (2 - 3 * tau) % p * tm1 % p)
                else:
                    evals = native.sumcheck_cubic_round_l(p, El, Al, Bl, Cl)
                r_i, claim_per_round = SumcheckProof._round(
                    field, polys, transcript, claim_per_round, evals, True)
                r.append(r_i)
                Al = native.vec_bind_l(p, Al, r_i)
                Bl = native.vec_bind_l(p, Bl, r_i)
                Cl = native.vec_bind_l(p, Cl, r_i)
                if gruen:
                    pre = pre * (tau * r_i + (1 - tau) * (1 - r_i)) % p
                else:
                    El = native.vec_bind_l(p, El, r_i)
            finals = [native.limbs_to_ints(t)[0] for t in (Al, Bl, Cl)]
            for pl, v in zip((poly_A, poly_B, poly_C), finals):
                pl.Z, pl.num_vars = [v], 0
            return SumcheckProof(polys), r, finals
        poly_eq = MultilinearPolynomial(field, EqPolynomial.evals_from_points(field, taus_r))
        for _ in range(num_rounds):
            half = len(poly_A) // 2
            e0 = c3 = em1 = 0
            EZ, AZ, BZ, CZ = poly_eq.Z, poly_A.Z, poly_B.Z, poly_C.Z
            for i in range(half):
                elo, ehi = EZ[i], EZ[half + i]
                alo, ahi = AZ[i], AZ[half + i]
                blo, bhi = BZ[i], BZ[half + i]
                clo, chi = CZ[i], CZ[half + i]
                de, da, db, dc = ehi - elo, ahi - alo, bhi - blo, chi - clo
                e0 += elo * (alo * blo - clo)
                c3 += de * da * db
                em1 += (elo - de) * ((alo - da) * (blo - db) - (clo - dc))
            r_i, claim_per_round = SumcheckProof._round(
                field, polys, transcript, claim_per_round, (e0 % p, c3 % p, em1 % p), True)
            r.append(r_i)
            for pl in (poly_A, poly_B, poly_C, poly_eq):
                pl.bind_poly_var_top(r_i)
        return SumcheckProof(polys), r, [poly_A.Z[0], poly_B.Z[0], poly_C.Z[0]]

    @staticmethod
    def prove_batched_cubic(
        field: FieldSpec,
        claim: int,
        taus: Sequence[int],
        polys_A: List[MultilinearPolynomial],
        polys_B: List[MultilinearPolynomial],
        polys_C: List[MultilinearPolynomial],
        alphas: Sequence[int],
        transcript,
    ) -> Tuple["SumcheckProof", List[int], List[List[int]]]:
        """sum_x eq(tau,x) * sum_k alpha_k (A_k B_k - C_k) = claim
        (src/spartan/sumcheck.rs:509-577)."""
        p = field.p
        k = len(polys_A)
        assert k and len(polys_B) == k and len(polys_C) == k and len(alphas) == k
        poly_eq = MultilinearPolynomial(field, EqPolynomial.evals_from_points(field, list(taus)))
        r: List[int] = []
        out_polys: List[CompressedUniPoly] = []
        claim_per_round = claim % p
        for _ in range(len(taus)):
            half = len(polys_A[0]) // 2
            e0 = c3 = em1 = 0
            EZ = poly_eq.Z
            for i in range(half):
                elo = EZ[i]
                de = EZ[half + i] - elo
                s0 = sm1 = sc3 = 0
                for j in range(k):
                    AZ, BZ, CZ = polys_A[j].Z, polys_B[j].Z, polys_C[j].Z
                    alo, blo, clo = AZ[i], BZ[i], CZ[i]
                    da, db, dc = AZ[half + i] - alo, BZ[half + i] - blo, CZ[half + i] - clo
                    a = alphas[j]
                    s0 += a * (alo * blo - clo)
                    sc3 += a * (da * db)
                    sm1 += a * ((alo - da) * (blo - db) - (clo - dc))
                e0 += elo * s0
                c3 += de * sc3
                em1 += (elo - de) * sm1
            r_i, claim_per_round = SumcheckProof._round(
                field, out_polys, transcript, claim_per_round, (e0 % p, c3 % p, em1 % p), True)
            r.append(r_i)
            for pl in (*polys_A, *polys_B, *polys_C, poly_eq):
                pl.bind_poly_var_top(r_i)
        claims = [[polys_A[j].Z[0], polys_B[j].Z[0], polys_C[j].Z[0]] for j in range(k)]
        return SumcheckProof(out_polys), r, claims

    @staticmethod
    def prove_batch_eval(
        field: FieldSpec,
        claims: Sequence[int],
        num_rounds: Sequence[int],
        polys: List[MultilinearPolynomial],
        eq_points: List[List[int]],
        coeffs: Sequence[int],
        transcript,
    ) -> Tuple["SumcheckProof", List[int], List[int]]:
        """Batched evaluation sumcheck: instance i proves
        e_i = sum_x P_i(x) * eq(x_i, x) over {0,1}^{n_i}
        (src/spartan/sumcheck.rs:246-357). Instances of different sizes
        join once remaining_rounds <= n_i; before that they contribute a
        constant 2^{remaining-1} * claim_i."""
        p = field.p
        num_claims = len(claims)
        assert len(num_rounds) == num_claims == len(polys) == len(eq_points) == len(coeffs)
        for i, nr in enumerate(num_rounds):
            assert len(polys[i]) == (1 << nr)
            assert len(eq_points[i]) == nr

        nr_max = max(num_rounds)
        eq_polys = [
            MultilinearPolynomial(field, EqPolynomial.evals_from_points(field, pts))
            for pts in eq_points
        ]
        running_claims = [c % p for c in claims]
        e = 0
        for c, nr, co in zip(claims, num_rounds, coeffs):
            e = (e + c * pow(2, nr_max - nr, p) % p * co) % p

        r: List[int] = []
        quad_polys: List[CompressedUniPoly] = []
        for current_round in range(nr_max):
            remaining = nr_max - current_round
            evals = []
            for i in range(num_claims):
                if remaining <= num_rounds[i]:
                    half = len(polys[i]) // 2
                    e0 = em1 = 0
                    PZ, QZ = polys[i].Z, eq_polys[i].Z
                    for j in range(half):
                        plo, phi = PZ[j], PZ[half + j]
                        qlo, qhi = QZ[j], QZ[half + j]
                        e0 += plo * qlo
                        em1 += (2 * plo - phi) * (2 * qlo - qhi)
                    evals.append([e0 % p, 0, em1 % p])
                else:
                    scaled = pow(2, remaining - num_rounds[i] - 1, p) * claims[i] % p
                    evals.append([scaled, 0, scaled])

            e0c = sum(evals[i][0] * coeffs[i] for i in range(num_claims)) % p
            em1c = sum(evals[i][2] * coeffs[i] for i in range(num_claims)) % p
            e1c = (e - e0c) % p
            quad_coeff = (e1c + em1c - 2 * e0c) * field.inv(2) % p
            poly = UniPoly.from_evals_deg2(field, [e0c, e1c, quad_coeff])

            transcript.absorb(b"p", poly)
            r_i = transcript.squeeze(b"c")
            r.append(r_i)
            for i in range(num_claims):
                if remaining <= num_rounds[i]:
                    running_claims[i] = SumcheckProof.update_claim(
                        field, running_claims[i], evals[i], r_i
                    )
                    polys[i].bind_poly_var_top(r_i)
                    eq_polys[i].bind_poly_var_top(r_i)
            e = poly.evaluate(r_i)
            quad_polys.append(poly.compress())

        for pl in polys:
            assert len(pl) == 1
        return SumcheckProof(quad_polys), r, [pl.Z[0] for pl in polys]
