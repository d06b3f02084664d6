"""Bulletproofs-style inner-product argument evaluation engine (port of
``nova_tpu/provider/ipa.py``; reference: src/provider/ipa_pc.rs).

Proves eval = <poly, eq(point, .)> against a Pedersen commitment via
log-round halving; verification uses the tensor-structured vector s to do
a single MSM (``CommitmentEngine.commit``: a device MSM at or above
DEVICE_THRESHOLD, the native host MSM below it) instead of replaying folds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from nova_tpu_torch import native
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.errors import InvalidInputLengthError, ProofVerifyError
from nova_tpu_torch.fields.spec import FieldSpec
from nova_tpu_torch.ops.fvec import HVec
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine, CommitmentKey
from nova_tpu_torch.spartan import batch_invert
from nova_tpu_torch.spartan.polys import EqPolynomial


@dataclass
class IPAProverKey:
    ck_s: CommitmentKey


@dataclass
class IPAVerifierKey:
    ck_v: CommitmentKey
    ck_s: CommitmentKey


class InnerProductInstance:
    def __init__(self, comm_a_vec: Commitment, b_vec: List[int], c: int):
        self.comm_a_vec = comm_a_vec
        self.b_vec = b_vec
        self.c = c

    def to_transcript_bytes(self, field: FieldSpec) -> bytes:
        # b_vec is excluded: it is derived from the transcript
        return self.comm_a_vec.to_transcript_bytes() + field.to_repr(self.c % field.p)


def _inner_product(field: FieldSpec, a: Sequence[int], b: Sequence[int]) -> int:
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % field.p


class InnerProductArgument:
    """L_vec/R_vec halving rounds + final folded scalar
    (src/provider/ipa_pc.rs:158-390)."""

    def __init__(self, L_vec: List[Commitment], R_vec: List[Commitment], a_hat: int):
        self.L_vec = L_vec
        self.R_vec = R_vec
        self.a_hat = a_hat

    @staticmethod
    def prove(
        field: FieldSpec,
        ck: CommitmentKey,
        ck_c: CommitmentKey,
        U: InnerProductInstance,
        a_vec: List[int],
        transcript,
    ) -> "InnerProductArgument":
        """Folded-key-free prover. The reference folds the commitment key
        every round (ck.fold(r_inv, r)); instead the original generators
        are kept, with a weight w[k] = prod over past rounds of (r_t if
        bit_t(k) else r_inv_t) per original index k, bit_t being k's t-th
        most-significant bit. Folded key position i is then
        sum_{k: low(k) = i} w[k] * G[k], so each round's L and R are
        size-N/2 MSMs over fixed index subsets: the reference's points at
        Pippenger cost."""
        p = field.p
        transcript.dom_sep(b"IPA")
        ck, _ = ck.split_at(len(U.b_vec))
        if len(U.b_vec) != len(a_vec):
            raise InvalidInputLengthError()

        transcript.absorb(b"U", U.to_transcript_bytes(field))
        r = transcript.squeeze(b"r")
        ck_c = ck_c.scale(r)

        L_vec: List[Commitment] = []
        R_vec: List[Commitment] = []
        N = len(a_vec)
        ck_c_gen = ck_c.ck[0]
        rounds = N.bit_length() - 1

        def rnd(L, R):
            transcript.absorb(b"L", L)
            transcript.absorb(b"R", R)
            L_vec.append(L)
            R_vec.append(R)
            r_i = transcript.squeeze(b"r")
            return r_i, field.inv(r_i)

        if native.available() and N >= 4:
            # limb-array round loop: scalars and weights stay (n, 4) uint64
            # and the field math runs in the native kernels; Python ints
            # appear only at the transcript boundary
            gx, gy, ginf = ck.host_arrays(N)
            cx, cy, cinf = native.marshal_points([ck_c_gen])
            arrays = (np.vstack([gx[:N], cx]), np.vstack([gy[:N], cy]),
                      np.concatenate([ginf[:N], cinf]))
            a = a_vec.limbs64() if isinstance(a_vec, HVec) else native.ints_to_limbs(
                [x % p for x in a_vec])
            b = U.b_vec.limbs64() if isinstance(U.b_vec, HVec) else native.ints_to_limbs(
                [x % p for x in U.b_vec])
            w = native.ints_to_limbs([1] * N)
            kidx = np.arange(N, dtype=np.uint32)
            extra = np.array([N], dtype=np.uint32)
            for _ in range(rounds):
                n2 = a.shape[0] // 2
                c_L = native.vec_dot_l(p, a[:n2], b[n2:])
                c_R = native.vec_dot_l(p, a[n2:], b[:n2])
                low = kidx & (n2 - 1)
                hi_mask = (kidx & n2) != 0
                idx_hi, idx_lo = kidx[hi_mask], kidx[~hi_mask]
                Ls = np.vstack([native.vec_mulmod_l(p, a[low[idx_hi]], w[idx_hi]),
                                native.ints_to_limbs([c_L])])
                Rs = np.vstack([native.vec_mulmod_l(p, a[n2 + low[idx_lo]], w[idx_lo]),
                                native.ints_to_limbs([c_R])])
                r_i, r_inv = rnd(
                    Commitment(native.msm_cached(ck.curve, arrays, Ls,
                                                 np.concatenate([idx_hi, extra]))),
                    Commitment(native.msm_cached(ck.curve, arrays, Rs,
                                                 np.concatenate([idx_lo, extra]))),
                )
                a = native.vec_fold_l(p, a[:n2], a[n2:], r_i, r_inv)
                b = native.vec_fold_l(p, b[:n2], b[n2:], r_inv, r_i)
                fac = np.empty((N, 4), dtype=np.uint64)
                fac[hi_mask] = native.ints_to_limbs([r_i])[0]
                fac[~hi_mask] = native.ints_to_limbs([r_inv])[0]
                w = native.vec_mulmod_l(p, w, fac)
            return InnerProductArgument(L_vec, R_vec, native.limbs_to_ints(a[:1])[0])

        # pure-Python round loop: the same math on int lists
        gens = ck.ck[:N]
        a_vec = [x % p for x in a_vec]
        b_vec = [x % p for x in U.b_vec]
        w = [1] * N
        for _ in range(rounds):
            n2 = len(a_vec) // 2
            c_L = _inner_product(field, a_vec[:n2], b_vec[n2:])
            c_R = _inner_product(field, a_vec[n2:], b_vec[:n2])
            low_mask = n2 - 1
            Lp, Ls, Rp, Rs = [], [], [], []
            for k in range(N):
                if k & n2:
                    Lp.append(gens[k])
                    Ls.append(a_vec[k & low_mask] * w[k] % p)
                else:
                    Rp.append(gens[k])
                    Rs.append(a_vec[n2 + (k & low_mask)] * w[k] % p)
            r_i, r_inv = rnd(Commitment(host_msm(Ls + [c_L], Lp + [ck_c_gen])),
                             Commitment(host_msm(Rs + [c_R], Rp + [ck_c_gen])))
            a_vec = [(aL * r_i + r_inv * aR) % p for aL, aR in zip(a_vec[:n2], a_vec[n2:])]
            b_vec = [(bL * r_inv + r_i * bR) % p for bL, bR in zip(b_vec[:n2], b_vec[n2:])]
            for k in range(N):
                w[k] = w[k] * (r_i if k & n2 else r_inv) % p
        return InnerProductArgument(L_vec, R_vec, a_vec[0])

    def verify(
        self,
        field: FieldSpec,
        ck: CommitmentKey,
        ck_c: CommitmentKey,
        n: int,
        U: InnerProductInstance,
        transcript,
    ) -> None:
        p = field.p
        ck, _ = ck.split_at(len(U.b_vec))
        transcript.dom_sep(b"IPA")
        if (
            len(U.b_vec) != n
            or n != (1 << len(self.L_vec))
            or len(self.L_vec) != len(self.R_vec)
            or len(self.L_vec) >= 32
        ):
            raise InvalidInputLengthError()

        transcript.absorb(b"U", U.to_transcript_bytes(field))
        r = transcript.squeeze(b"r")
        ck_c = ck_c.scale(r)

        P = U.comm_a_vec.point.add(CommitmentEngine.commit(ck_c, [U.c], 0).point)

        rs: List[int] = []
        for L, R in zip(self.L_vec, self.R_vec):
            transcript.absorb(b"L", L)
            transcript.absorb(b"R", R)
            rs.append(transcript.squeeze(b"r"))

        r_sq = [x * x % p for x in rs]
        r_inv = batch_invert(field, rs)
        r_inv_sq = [x * x % p for x in r_inv]

        # tensor-structure vector s
        s = [0] * n
        v = 1
        for x in r_inv:
            v = v * x % p
        s[0] = v
        for i in range(1, n):
            pos = i.bit_length() - 1
            s[i] = s[i - (1 << pos)] * r_sq[len(self.L_vec) - 1 - pos] % p

        ck_hat_point = CommitmentEngine.commit(ck, s, 0).point
        b_hat = _inner_product(field, U.b_vec, s)

        # P_hat = sum r_i^2 L_i + sum r_i^-2 R_i + P
        pt = None
        for w, L in zip(r_sq, self.L_vec):
            t = L.point.mul(w)
            pt = t if pt is None else pt.add(t)
        for w, R in zip(r_inv_sq, self.R_vec):
            pt = pt.add(R.point.mul(w))
        P_hat = pt.add(P)

        rhs = ck_hat_point.mul(self.a_hat).add(ck_c.ck[0].mul(self.a_hat * b_hat % p))
        if P_hat != rhs:
            raise ProofVerifyError("IPA verification failed")


class EvaluationEngine:
    """EvaluationEngineTrait over Pedersen (src/provider/ipa_pc.rs:39-102)."""

    @staticmethod
    def setup(engine, ck: CommitmentKey) -> Tuple[IPAProverKey, IPAVerifierKey]:
        ck_c = CommitmentEngine.setup(engine.curve, b"ipa", 1, device=ck.device)
        return IPAProverKey(ck_c), IPAVerifierKey(ck, ck_c)

    @staticmethod
    def prove(
        engine,
        ck: CommitmentKey,
        pk: IPAProverKey,
        transcript,
        comm: Commitment,
        poly: List[int],
        point: List[int],
        eval_v: int,
    ) -> InnerProductArgument:
        field = engine.scalar
        b_vec = EqPolynomial.evals_hvec(field, list(point))
        U = InnerProductInstance(comm, b_vec, eval_v)
        return InnerProductArgument.prove(field, ck, pk.ck_s, U, poly, transcript)

    @staticmethod
    def verify(
        engine,
        vk: IPAVerifierKey,
        transcript,
        comm: Commitment,
        point: List[int],
        eval_v: int,
        arg: InnerProductArgument,
    ) -> None:
        field = engine.scalar
        b_vec = EqPolynomial.evals_from_points(field, list(point))
        U = InnerProductInstance(comm, b_vec, eval_v)
        arg.verify(field, vk.ck_v, vk.ck_s, 1 << len(point), U, transcript)
