"""Non-preprocessing Spartan SNARK over Relaxed R1CS (port of
``nova_tpu/spartan/snark.py``; reference: src/spartan/snark.rs).

Outer cubic sumcheck: 0 = sum_x eq(tau,x) * (Az*Bz - u*Cz - E), on the
device (``ops.sumcheck``, the key's device) at or above DEVICE_THRESHOLD
constraints; inner quadratic sumcheck on (A + r B + r^2 C)(r_x, .) * Z;
then the W/E evaluation claims are batched into one PCS opening.

The reference's mesh-sharded outer sumcheck is not ported yet (slice 4,
``parallel``): one device proves.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

from nova_tpu_torch import constants, native, profiling
from nova_tpu_torch.digest import map_to_field
from nova_tpu_torch.errors import InvalidSumcheckProofError
from nova_tpu_torch.ops.fvec import HVec
from nova_tpu_torch.spartan import (
    PolyEvalInstance,
    PolyEvalWitness,
    batch_eval_reduce,
    batch_eval_verify,
    compute_eval_table_sparse,
)
from nova_tpu_torch.spartan.polys import (
    EqPolynomial,
    MultilinearPolynomial,
    SparsePolynomial,
    log2_int,
)
from nova_tpu_torch.spartan.sumcheck import SumcheckProof


@dataclass
class SpartanProverKey:
    vk_digest: int
    ee_pk: object
    ee: object = None


class SpartanVerifierKey:
    def __init__(self, engine, S, ee_vk, ee=None):
        self.engine = engine
        self.S = S
        self.ee_vk = ee_vk
        self.ee = ee
        self._digest = None

    def digest(self) -> int:
        """SHA3 over the padded shape (src/spartan/snark.rs:43-66)."""
        if self._digest is None:
            from nova_tpu_torch.digest import DigestComputer, _u64

            h = hashlib.sha3_256()
            h.update(b"nova_tpu.SpartanVerifierKey")
            h.update(_u64(self.S.num_cons))
            h.update(_u64(self.S.num_vars))
            h.update(_u64(self.S.num_io))
            for M in (self.S.A, self.S.B, self.S.C):
                h.update(DigestComputer.digest_bytes_sparse(M))
            self._digest = map_to_field(h.digest(), self.engine.scalar)
        return self._digest


class RelaxedR1CSSNARK:
    """src/spartan/snark.rs:79-391. Parameterized by an evaluation engine
    (provider.ipa.EvaluationEngine by default)."""

    def __init__(
        self,
        sc_proof_outer: SumcheckProof,
        claims_outer: Tuple[int, int, int],
        eval_E: int,
        sc_proof_inner: SumcheckProof,
        eval_W: int,
        sc_proof_batch: SumcheckProof,
        evals_batch: List[int],
        eval_arg,
    ):
        self.sc_proof_outer = sc_proof_outer
        self.claims_outer = claims_outer
        self.eval_E = eval_E
        self.sc_proof_inner = sc_proof_inner
        self.eval_W = eval_W
        self.sc_proof_batch = sc_proof_batch
        self.evals_batch = evals_batch
        self.eval_arg = eval_arg

    # -- setup ---------------------------------------------------------------
    @staticmethod
    def setup(engine, ck, S, ee=None):
        ee = ee or _default_ee()
        ee_pk, ee_vk = ee.setup(engine, ck)
        S = S.pad()
        vk = SpartanVerifierKey(engine, S, ee_vk, ee)
        pk = SpartanProverKey(vk_digest=vk.digest(), ee_pk=ee_pk, ee=ee)
        return pk, vk

    @staticmethod
    def ck_floor(S) -> int:
        """No extra commitment-key requirement (snark.rs default)."""
        return 0

    # -- prover ----------------------------------------------------------------
    @staticmethod
    def prove(engine, ck, pk: SpartanProverKey, S, U, W, ee=None) -> "RelaxedR1CSSNARK":
        ee = ee or pk.ee or _default_ee()
        field = engine.scalar
        p = field.p

        S = S.pad()
        assert S.is_regular_shape()
        W = W.pad(S)

        transcript = engine.new_transcript(b"RelaxedR1CSSNARK")
        transcript.absorb(b"vk", field.to_repr(pk.vk_digest))
        transcript.absorb(b"U", U.to_transcript_bytes(field))

        num_rounds_x = log2_int(S.num_cons)
        num_rounds_y = log2_int(S.num_vars) + 1

        # outer sumcheck
        tau = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]
        with profiling.phase("spartan_outer"):
            Az, Bz, Cz, uCz_E = _outer_tables(field, S, U, W, ck.device)
            sc_proof_outer, r_x, claims_outer = _prove_outer(
                field, S, tau, Az, Bz, uCz_E, transcript, ck.device)
            claim_Az, claim_Bz = claims_outer[0], claims_outer[1]
            claim_Cz = MultilinearPolynomial(field, Cz).evaluate(r_x)
            eval_E = MultilinearPolynomial(field, list(W.E)).evaluate(r_x)
        transcript.absorb(
            b"claims_outer", _scalars(field, [claim_Az, claim_Bz, claim_Cz, eval_E])
        )

        # inner sumcheck
        with profiling.phase("spartan_inner"):
            r = transcript.squeeze(b"r")
            claim_inner_joint = (claim_Az + r * claim_Bz + r * r % p * claim_Cz) % p

            evals_rx = EqPolynomial.evals_from_points(field, list(r_x))
            evals_A, evals_B, evals_C = compute_eval_table_sparse(S, evals_rx)
            r2 = r * r % p
            poly_ABC = MultilinearPolynomial(
                field, [(a + r * b + r2 * c) % p for a, b, c in zip(evals_A, evals_B, evals_C)]
            )
            z = list(W.W) + [U.u] + list(U.X)
            poly_z = MultilinearPolynomial(field, z + [0] * (2 * S.num_vars - len(z)))

            sc_proof_inner, r_y, _claims_inner = SumcheckProof.prove_quad_prod(
                field, claim_inner_joint, num_rounds_y, poly_ABC, poly_z, transcript
            )
            eval_W = MultilinearPolynomial.evaluate_with(field, list(W.W), r_y[1:])

        with profiling.phase("spartan_batch_eval"):
            w_vec = [PolyEvalWitness(list(W.W)), PolyEvalWitness(list(W.E))]
            u_vec = [
                PolyEvalInstance(U.comm_W, list(r_y[1:]), eval_W),
                PolyEvalInstance(U.comm_E, list(r_x), eval_E),
            ]
            batched_u, batched_w, _chal, sc_proof_batch, claims_batch_left = batch_eval_reduce(
                field, u_vec, w_vec, transcript
            )

        with profiling.phase("spartan_ipa"):
            eval_arg = ee.prove(engine, ck, pk.ee_pk, transcript, batched_u.c,
                                batched_w.p, batched_u.x, batched_u.e)

        return RelaxedR1CSSNARK(
            sc_proof_outer,
            (claim_Az, claim_Bz, claim_Cz),
            eval_E,
            sc_proof_inner,
            eval_W,
            sc_proof_batch,
            claims_batch_left,
            eval_arg,
        )

    # -- verifier ---------------------------------------------------------------
    def verify(self, vk: SpartanVerifierKey, U, ee=None) -> None:
        ee = ee or vk.ee or _default_ee()
        engine = vk.engine
        field = engine.scalar
        p = field.p

        transcript = engine.new_transcript(b"RelaxedR1CSSNARK")
        transcript.absorb(b"vk", field.to_repr(vk.digest()))
        transcript.absorb(b"U", U.to_transcript_bytes(field))

        num_rounds_x = log2_int(vk.S.num_cons)
        num_rounds_y = log2_int(vk.S.num_vars) + 1

        tau = [transcript.squeeze(b"t") for _ in range(num_rounds_x)]

        claim_outer_final, r_x = self.sc_proof_outer.verify(
            field, 0, num_rounds_x, 3, transcript
        )
        claim_Az, claim_Bz, claim_Cz = self.claims_outer
        taus_bound_rx = EqPolynomial(field, tau).evaluate(r_x)
        expected = (
            taus_bound_rx
            * ((claim_Az * claim_Bz - U.u * claim_Cz - self.eval_E) % p)
            % p
        )
        if claim_outer_final != expected:
            raise InvalidSumcheckProofError()

        transcript.absorb(
            b"claims_outer",
            _scalars(field, [claim_Az, claim_Bz, claim_Cz, self.eval_E]),
        )

        r = transcript.squeeze(b"r")
        claim_inner_joint = (claim_Az + r * claim_Bz + r * r % p * claim_Cz) % p

        claim_inner_final, r_y = self.sc_proof_inner.verify(
            field, claim_inner_joint, num_rounds_y, 2, transcript
        )

        X = [U.u] + list(U.X)
        eval_X = SparsePolynomial(field, log2_int(vk.S.num_vars), X).evaluate(r_y[1:])
        eval_Z = ((1 - r_y[0]) * self.eval_W + r_y[0] * eval_X) % p

        T_x = EqPolynomial.evals_from_points(field, r_x)
        T_y = EqPolynomial.evals_from_points(field, r_y)
        evals = []
        for M in (vk.S.A, vk.S.B, vk.S.C):
            acc = 0
            for row in range(M.rows):
                tx = T_x[row]
                if tx == 0:
                    continue
                for k in range(M.indptr[row], M.indptr[row + 1]):
                    acc += tx * T_y[M.indices[k]] % p * M.data[k]
            evals.append(acc % p)

        expected_inner = (evals[0] + r * evals[1] + r * r % p * evals[2]) % p * eval_Z % p
        if claim_inner_final != expected_inner:
            raise InvalidSumcheckProofError()

        u_vec = [
            PolyEvalInstance(U.comm_W, list(r_y[1:]), self.eval_W),
            PolyEvalInstance(U.comm_E, list(r_x), self.eval_E),
        ]
        batched_u, _chal = batch_eval_verify(
            field, u_vec, transcript, self.sc_proof_batch, self.evals_batch
        )

        ee.verify(engine, vk.ee_vk, transcript, batched_u.c, batched_u.x, batched_u.e,
                  self.eval_arg)


def _outer_tables(field, S, U, W, device=None):
    """(Az, Bz, Cz, u*Cz + E) of the padded shape, HVecs through the
    native SpMV when the binding is available, else int lists (SpMV on
    `device` at or above DEVICE_THRESHOLD)."""
    p = field.p
    z = list(W.W) + [U.u] + list(U.X)
    if native.available():
        from nova_tpu_torch.r1cs import _vec_limbs

        Azl, Bzl, Czl = S.multiply_vec_l(_vec_limbs(z, p))
        uCz_E = native.vec_axpy_l(p, _vec_limbs(W.E, p), Czl, U.u)
        return (HVec(p, limbs=Azl), HVec(p, limbs=Bzl), HVec(p, limbs=Czl),
                HVec(p, limbs=uCz_E))
    Az, Bz, Cz = S.multiply_vec(z, device)
    return Az, Bz, Cz, [(U.u * c + e) % p for c, e in zip(Cz, W.E)]


def _prove_outer(field, S, tau, Az, Bz, uCz_E, transcript, device):
    """The outer sumcheck sum eq(tau, x) (Az*Bz - uCz_E)(x) = 0 on the first
    route that applies: sharded over the active mesh when it has more than
    one device and 2 or more evaluations a device, on `device` at
    DEVICE_THRESHOLD constraints, else on the host. All three give the same
    proof."""
    from nova_tpu_torch.parallel import current_mesh

    mesh = current_mesh()
    if mesh is not None and mesh.size > 1 and (1 << len(tau)) // mesh.size >= 2:
        from nova_tpu_torch.parallel import prove_cubic_with_three_inputs_sharded

        return prove_cubic_with_three_inputs_sharded(
            field, 0, tau, Az, Bz, uCz_E, transcript, mesh)
    if S.num_cons >= constants.DEVICE_THRESHOLD:
        from nova_tpu_torch.ops.sumcheck import prove_cubic_with_three_inputs_device

        return prove_cubic_with_three_inputs_device(
            field, 0, tau, Az, Bz, uCz_E, transcript, device=device)
    return SumcheckProof.prove_cubic_with_three_inputs(
        field, 0, tau, MultilinearPolynomial(field, Az), MultilinearPolynomial(field, Bz),
        MultilinearPolynomial(field, uCz_E), transcript)


def _scalars(field, v) -> bytes:
    return b"".join(field.to_repr(x % field.p) for x in v)


def _default_ee():
    from nova_tpu_torch.provider.ipa import EvaluationEngine

    return EvaluationEngine
