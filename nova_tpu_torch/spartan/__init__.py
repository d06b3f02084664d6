"""Spartan layer: shared helpers (port of ``nova_tpu/spartan/__init__.py``;
reference: src/spartan/mod.rs:40-534).

powers, batch_invert (Montgomery's trick), PolyEvalInstance/Witness
batching (same-size and different-size), the joint claim-reduction
sumcheck (batch_eval_reduce / batch_eval_verify), and
compute_eval_table_sparse (binding matrix row variables).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from nova_tpu_torch import native
from nova_tpu_torch.errors import InternalError, InvalidSumcheckProofError
from nova_tpu_torch.fields.spec import FieldSpec
from nova_tpu_torch.provider.pedersen import Commitment
from nova_tpu_torch.spartan.polys import EqPolynomial, MultilinearPolynomial
from nova_tpu_torch.spartan.sumcheck import SumcheckProof


def powers(field: FieldSpec, s: int, n: int) -> List[int]:
    """[1, s, s^2, ..., s^{n-1}] (src/spartan/mod.rs:40-48)."""
    assert n >= 1
    p = field.p
    out = [1]
    for _ in range(1, n):
        out.append(out[-1] * s % p)
    return out


def batch_invert(field: FieldSpec, v: Sequence[int]) -> List[int]:
    """Montgomery's trick (src/spartan/mod.rs:50-117); errors on zero."""
    p = field.p
    n = len(v)
    if native.available() and n >= 64:
        if any(x % p == 0 for x in v):
            raise InternalError("batch_invert of zero element")
        return native.batch_inv_ints(p, v)
    prods = [0] * n
    acc = 1
    for i in range(n):
        prods[i] = acc
        acc = acc * v[i] % p
    if acc == 0:
        raise InternalError("batch_invert of zero element")
    acc = field.inv(acc)
    inv = [0] * n
    for i in range(n - 1, -1, -1):
        inv[i] = prods[i] * acc % p
        acc = acc * v[i] % p
    return inv


@dataclass
class PolyEvalWitness:
    """A polynomial (dense evals) underlying an evaluation claim
    (src/spartan/mod.rs:145-277)."""

    p: List[int]

    @staticmethod
    def batch_diff_size(field: FieldSpec, W: List["PolyEvalWitness"], s: int) -> "PolyEvalWitness":
        """sum_k s^k * W_k, shorter polynomials zero-padded: an HVec through
        the native binding when it is available, else an int list."""
        pr = field.p
        pws = powers(field, s, len(W))
        size_max = max(len(w.p) for w in W)
        if native.available():
            from nova_tpu_torch.ops.fvec import HVec
            from nova_tpu_torch.r1cs import _vec_limbs

            acc = np.zeros((size_max, 4), dtype=np.uint64)
            for coeff, w in zip(pws, W):
                l = _vec_limbs(w.p, pr)
                if l.shape[0] < size_max:
                    l = np.vstack([l, np.zeros((size_max - l.shape[0], 4), dtype=np.uint64)])
                acc = native.vec_axpy_l(pr, acc, l, coeff)
            return PolyEvalWitness(HVec(pr, limbs=acc))
        out = [0] * size_max
        for coeff, w in zip(pws, W):
            for i, x in enumerate(w.p):
                out[i] = (out[i] + coeff * x) % pr
        return PolyEvalWitness(out)

    @staticmethod
    def batch(field: FieldSpec, p_vec: List[List[int]], s: int) -> "PolyEvalWitness":
        """sum_k s^k * p_k of equal-size polynomials: an HVec through the
        native binding when it is available, else an int list."""
        assert all(len(q) == len(p_vec[0]) for q in p_vec)
        pr = field.p
        pws = powers(field, s, len(p_vec))
        if native.available():
            from nova_tpu_torch.ops.fvec import HVec
            from nova_tpu_torch.r1cs import _vec_limbs

            acc = np.zeros((len(p_vec[0]), 4), dtype=np.uint64)
            for coeff, q in zip(pws, p_vec):
                acc = native.vec_axpy_l(pr, acc, _vec_limbs(q, pr), coeff)
            return PolyEvalWitness(HVec(pr, limbs=acc))
        out = [0] * len(p_vec[0])
        for coeff, q in zip(pws, p_vec):
            for i, x in enumerate(q):
                out[i] = (out[i] + coeff * x) % pr
        return PolyEvalWitness(out)


@dataclass
class PolyEvalInstance:
    """(commitment, point, claimed evaluation)
    (src/spartan/mod.rs:280-369)."""

    c: Commitment
    x: List[int]
    e: int

    @staticmethod
    def batch(
        field: FieldSpec,
        c_vec: Sequence[Commitment],
        x: Sequence[int],
        e_vec: Sequence[int],
        s: int,
    ) -> "PolyEvalInstance":
        """Instances at one point: sum_k s^k * (c_k, e_k)."""
        pr = field.p
        pws = powers(field, s, len(c_vec))
        e = sum(ei * w for ei, w in zip(e_vec, pws)) % pr
        pt = None
        for ci, w in zip(c_vec, pws):
            term = ci.point.mul(w)
            pt = term if pt is None else pt.add(term)
        return PolyEvalInstance(Commitment(pt), list(x), e)

    @staticmethod
    def batch_diff_size(
        field: FieldSpec,
        c_vec: Sequence[Commitment],
        e_vec: Sequence[int],
        num_vars: Sequence[int],
        x: List[int],
        s: int,
    ) -> "PolyEvalInstance":
        """Pad smaller instances: scale eval by L0(x_lo) = prod(1 - x_lo)
        (src/spartan/mod.rs:305-345)."""
        pr = field.p
        n = len(num_vars)
        assert len(c_vec) == n and len(e_vec) == n
        nv_max = len(x)
        pws = powers(field, s, n)
        e_joint = 0
        pt = None
        for ci, ei, nv, w in zip(c_vec, e_vec, num_vars, pws):
            lag = 1
            for r in x[: nv_max - nv]:
                lag = lag * (1 - r) % pr
            e_joint = (e_joint + w * (lag * ei % pr)) % pr
            term = ci.point.mul(w)
            pt = term if pt is None else pt.add(term)
        return PolyEvalInstance(Commitment(pt), list(x), e_joint)


def batch_eval_reduce(
    field: FieldSpec,
    u_vec: List[PolyEvalInstance],
    w_vec: List[PolyEvalWitness],
    transcript,
) -> Tuple[PolyEvalInstance, PolyEvalWitness, int, SumcheckProof, List[int]]:
    """Reduce a batch of evaluation claims to one via a joint sumcheck
    (src/spartan/mod.rs:377-432)."""
    num_claims = len(u_vec)
    assert len(w_vec) == num_claims
    num_rounds = [len(u.x) for u in u_vec]
    for w, nr in zip(w_vec, num_rounds):
        assert len(w.p) == (1 << nr)

    rho = transcript.squeeze(b"r")
    powers_of_rho = powers(field, rho, num_claims)

    claims = [u.e for u in u_vec]
    u_xs = [list(u.x) for u in u_vec]
    comms = [u.c for u in u_vec]

    polys_P = [MultilinearPolynomial(field, w.p) for w in w_vec]
    sc_proof_batch, r, claims_batch_left = SumcheckProof.prove_batch_eval(
        field, claims, num_rounds, polys_P, u_xs, powers_of_rho, transcript
    )

    transcript.absorb(b"l", _scalars_bytes(field, claims_batch_left))
    c = transcript.squeeze(b"c")

    u_joint = PolyEvalInstance.batch_diff_size(
        field, comms, claims_batch_left, num_rounds, r, c
    )
    w_joint = PolyEvalWitness.batch_diff_size(field, w_vec, c)
    return u_joint, w_joint, c, sc_proof_batch, claims_batch_left


def batch_eval_verify(
    field: FieldSpec,
    u_vec: List[PolyEvalInstance],
    transcript,
    sc_proof_batch: SumcheckProof,
    evals_batch: Sequence[int],
) -> Tuple[PolyEvalInstance, int]:
    """src/spartan/mod.rs:436-486."""
    pr = field.p
    num_claims = len(u_vec)
    assert len(evals_batch) == num_claims

    rho = transcript.squeeze(b"r")
    powers_of_rho = powers(field, rho, num_claims)

    num_rounds = [len(u.x) for u in u_vec]
    nr_max = max(num_rounds)
    claims = [u.e for u in u_vec]

    claim_batch_final, r = sc_proof_batch.verify_batch(
        field, claims, num_rounds, powers_of_rho, 2, transcript
    )

    expected = 0
    for u, ev, w in zip(u_vec, evals_batch, powers_of_rho):
        r_hi = r[nr_max - len(u.x):]
        e_i = EqPolynomial(field, r_hi).evaluate(u.x)
        expected = (expected + e_i * ev % pr * w) % pr

    if claim_batch_final != expected:
        raise InvalidSumcheckProofError()

    transcript.absorb(b"l", _scalars_bytes(field, evals_batch))
    c = transcript.squeeze(b"c")
    comms = [u.c for u in u_vec]
    u_joint = PolyEvalInstance.batch_diff_size(field, comms, evals_batch, num_rounds, r, c)
    return u_joint, c


def _scalars_bytes(field: FieldSpec, v: Sequence[int]) -> bytes:
    return b"".join(field.to_repr(x % field.p) for x in v)


def compute_eval_table_sparse(S, rx: Sequence[int]):
    """Bind row variables of A,B,C to rx: M_evals[col] = sum_row rx[row]*val
    (src/spartan/mod.rs:497-534). Returns 2*num_vars-length tables."""
    p = S.field.p

    def inner(M):
        evals = [0] * (2 * S.num_vars)
        for row in range(M.rows):
            rv = rx[row]
            if rv == 0:
                continue
            for k in range(M.indptr[row], M.indptr[row + 1]):
                col = M.indices[k]
                evals[col] = (evals[col] + rv * M.data[k]) % p
        return evals

    return inner(S.A), inner(S.B), inner(S.C)
