"""Preprocessing Spartan (MicroSpartan) over Relaxed R1CS (port of
``nova_tpu/spartan/ppsnark.py``; reference: src/spartan/ppsnark.rs).

The verifier holds only *commitments* to the R1CS matrices (the Spark
representation: row/col address vectors, val_A/B/C, and read-timestamp
vectors). Proving runs:
  1. a shortened outer sumcheck over log(num_cons) rounds, on the device
     (``ops.sumcheck``, the key's device) at or above DEVICE_THRESHOLD
     constraints,
  2. pad challenges extending r_outer to log(N),
  3. one batched cubic sumcheck driving three SumcheckEngines —
     MemorySumcheckInstance (LogUp grand-sum), InnerBatchedSumcheckInstance
     (ABC + E claims), WitnessBoundSumcheck (masked-eq zero-padding check),
  4. a 15-way batched PCS opening at r_inner.

With NOVA_PROFILE=1 ``prove`` records the phases ``pp_outer``,
``pp_oracles``, ``pp_inner`` and ``pp_ee``. The reference's mesh-sharded
outer sumcheck is not ported yet (``parallel``): one device proves.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from nova_tpu_torch import native, profiling
from nova_tpu_torch.digest import _u64, map_to_field
from nova_tpu_torch.errors import (
    InvalidCommitmentKeyLengthError,
    InvalidSumcheckProofError,
)
from nova_tpu_torch.ops.fvec import HVec
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine as CE
from nova_tpu_torch.spartan import (
    PolyEvalInstance,
    PolyEvalWitness,
    batch_invert,
    powers,
)
from nova_tpu_torch.spartan.polys import (
    EqPolynomial,
    IdentityPolynomial,
    MaskedEqPolynomial,
    MultilinearPolynomial,
    SparsePolynomial,
    UniPoly,
    log2_int,
)
from nova_tpu_torch.spartan.snark import _outer_tables, _prove_outer
from nova_tpu_torch.spartan.sumcheck import NATIVE_MIN, SumcheckProof


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def padded(v: Sequence[int], n: int) -> List[int]:
    out = list(v)
    out.extend([0] * (n - len(out)))
    return out


def _scalars(field, v) -> bytes:
    return b"".join(field.to_repr(x % field.p) for x in v)


def _comms(cs) -> bytes:
    return b"".join(c.to_transcript_bytes() for c in cs)


# ---------------------------------------------------------------------------
# Spark representation (ppsnark.rs:115-254)
# ---------------------------------------------------------------------------

class R1CSShapeSparkRepr:
    def __init__(self, S):
        field = S.field
        total_nz = S.A.nnz + S.B.nnz + S.C.nnz
        N = _next_pow2(max(total_nz, max(2 * S.num_vars, S.num_cons)))
        self.field = field
        self.N = N

        row = [0] * N
        col = [N - 1] * N  # col lookups default to the last (zero) entry of z
        val_A = [0] * N
        val_B = [0] * N
        val_C = [0] * N

        off = 0
        for M, val in ((S.A, val_A), (S.B, val_B), (S.C, val_C)):
            i = off
            for r, c, v in M.iter_triples():
                row[i], col[i], val[i] = r, c, v
                i += 1
            off += M.nnz

        ts_row = [0] * N
        ts_col = [0] * N
        for a in row:
            ts_row[a] += 1
        for a in col:
            ts_col[a] += 1

        self.row = row
        self.col = col
        self.val_A = val_A
        self.val_B = val_B
        self.val_C = val_C
        self.ts_row = ts_row
        self.ts_col = ts_col

    @classmethod
    def from_vectors(cls, field, N: int, row, col, val_A, val_B, val_C, ts_row,
                     ts_col) -> "R1CSShapeSparkRepr":
        """A representation from its seven vectors (of N entries each)."""
        out = cls.__new__(cls)
        out.field, out.N = field, N
        vecs = [list(v) for v in (row, col, val_A, val_B, val_C, ts_row, ts_col)]
        if any(len(v) != N for v in vecs):
            raise ValueError(f"spark vectors must have N = {N} entries")
        (out.row, out.col, out.val_A, out.val_B, out.val_C, out.ts_row,
         out.ts_col) = vecs
        return out

    def vectors(self) -> List[List[int]]:
        """row, col, val_A, val_B, val_C, ts_row, ts_col: the commit order."""
        return [self.row, self.col, self.val_A, self.val_B, self.val_C,
                self.ts_row, self.ts_col]

    def commit(self, ck) -> "R1CSShapeSparkCommitment":
        cs = [CE.commit(ck, v, 0) for v in self.vectors()]
        return R1CSShapeSparkCommitment(self.N, *cs)

    def evaluation_oracles(self, S, r_outer_full, z):
        """ppsnark.rs:220-254: mem_row = eq(r_outer_full), mem_col = padded z,
        L_row[i] = mem_row[row[i]], L_col[i] = mem_col[col[i]]."""
        field = self.field
        if native.available():
            from nova_tpu_torch.r1cs import _vec_limbs

            p = field.p
            mr = native.eq_evals_l(p, [x % p for x in r_outer_full])
            zl = _vec_limbs(z, p)
            if zl.shape[0] < self.N:
                zl = np.vstack([zl, np.zeros((self.N - zl.shape[0], 4), dtype=np.uint64)])
            row = np.asarray(self.row, dtype=np.int64)
            col = np.asarray(self.col, dtype=np.int64)
            return (
                HVec(p, limbs=mr),
                HVec(p, limbs=zl),
                HVec(p, limbs=np.ascontiguousarray(mr[row])),
                HVec(p, limbs=np.ascontiguousarray(zl[col])),
            )
        mem_row = EqPolynomial.evals_from_points(field, list(r_outer_full))
        mem_col = padded(z, self.N)
        L_row = [mem_row[a] for a in self.row]
        L_col = [mem_col[a] for a in self.col]
        return mem_row, mem_col, L_row, L_col


@dataclass
class R1CSShapeSparkCommitment:
    N: int
    comm_row: Commitment
    comm_col: Commitment
    comm_val_A: Commitment
    comm_val_B: Commitment
    comm_val_C: Commitment
    comm_ts_row: Commitment
    comm_ts_col: Commitment

    def comms(self) -> List[Commitment]:
        return [self.comm_row, self.comm_col, self.comm_val_A, self.comm_val_B,
                self.comm_val_C, self.comm_ts_row, self.comm_ts_col]

    def to_transcript_bytes(self) -> bytes:
        return _comms(self.comms())


# ---------------------------------------------------------------------------
# Sumcheck engines (all evaluation points as [P(0), cubic_coeff, P(-1)])
# ---------------------------------------------------------------------------

class WitnessBoundSumcheck:
    """0 = sum masked_eq(tau)[i] * W[i] (ppsnark.rs:257-325)."""

    def __init__(self, field, tau: List[int], poly_W_padded: List[int], num_vars: int):
        self.field = field
        num_vars_log = log2_int(num_vars)
        assert num_vars_log < log2_int(len(poly_W_padded))
        eq = EqPolynomial(field, tau)
        self.poly_W = MultilinearPolynomial(field, poly_W_padded)
        self.poly_masked_eq = MultilinearPolynomial(
            field, MaskedEqPolynomial(eq, num_vars_log).evals()
        )

    def initial_claims(self):
        return [0]

    def size(self):
        return len(self.poly_W)

    def evaluation_points(self):
        p = self.field.p
        if native.available() and len(self.poly_W) >= NATIVE_MIN:
            e0, em1 = native.sumcheck_quadeval_round_l(
                p, self.poly_masked_eq.to_limbs(), self.poly_W.to_limbs()
            )
            return [[e0, 0, em1]]
        half = len(self.poly_W) // 2
        A, B = self.poly_masked_eq.Z, self.poly_W.Z
        e0 = em1 = 0
        for i in range(half):
            alo, ahi = A[i], A[half + i]
            blo, bhi = B[i], B[half + i]
            e0 += alo * blo
            em1 += (2 * alo - ahi) * (2 * blo - bhi)
        return [[e0 % p, 0, em1 % p]]

    def bound(self, r):
        self.poly_W.bind_poly_var_top(r)
        self.poly_masked_eq.bind_poly_var_top(r)

    def final_claims(self):
        return [[self.poly_W.Z[0], self.poly_masked_eq.Z[0]]]


class MemorySumcheckInstance:
    """LogUp grand-sum (ppsnark.rs:328-690): 6 claims —
    0/1: sum (t_inv - w_inv) = 0 for row/col (linear);
    2-5: sum eq(rho)*(inv*(val+r) - target) = 0 (cubic)."""

    def __init__(self, field, polys_oracle, polys_aux, rhos, ts_row, ts_col):
        self.field = field
        t_inv_row, w_inv_row, t_inv_col, w_inv_col = polys_oracle
        t_row, w_row, t_col, w_col = polys_aux

        def M(v):
            return MultilinearPolynomial(field, v)

        self.t_plus_r_inv_row = M(t_inv_row)
        self.w_plus_r_inv_row = M(w_inv_row)
        self.t_plus_r_inv_col = M(t_inv_col)
        self.w_plus_r_inv_col = M(w_inv_col)
        self.t_plus_r_row = M(t_row)
        self.w_plus_r_row = M(w_row)
        self.t_plus_r_col = M(t_col)
        self.w_plus_r_col = M(w_col)
        self.ts_row = M(list(ts_row))
        self.ts_col = M(list(ts_col))
        self.poly_eq = M(EqPolynomial.evals_hvec(field, list(rhos)))

    @staticmethod
    def compute_oracles(field, ck, r, gamma, mem_row, addr_row, L_row, ts_row,
                        mem_col, addr_col, L_col, ts_col):
        """ppsnark.rs:390-490: T/W hashes, LogUp inverse oracles + commits."""
        p = field.p
        if native.available():
            from nova_tpu_torch.r1cs import _vec_limbs

            def small_limbs(vals):
                out = np.zeros((len(vals), 4), dtype=np.uint64)
                out[:, 0] = np.asarray(vals, dtype=np.uint64)
                return out

            def hash_vecs_l(mem, addr, lookups):
                n = len(mem)
                idx = np.zeros((n, 4), dtype=np.uint64)
                idx[:, 0] = np.arange(n, dtype=np.uint64)
                T = native.vec_axpy_l(p, idx, _vec_limbs(mem, p), gamma)
                W = native.vec_axpy_l(p, small_limbs(addr), _vec_limbs(lookups, p), gamma)
                return T, W

            def helper_l(T, W, TS):
                n = T.shape[0]
                ones = np.zeros((2 * n, 4), dtype=np.uint64)
                ones[:, 0] = 1
                both = native.vec_axpy_l(p, np.vstack([T, W]), ones, r)
                inv = native.vec_batch_inv_l(p, both)
                t_plus_r, w_plus_r = both[:n], both[n:]
                t_inv = native.vec_mulmod_l(p, inv[:n], _vec_limbs(TS, p))
                w_inv = inv[n:]
                return (HVec(p, limbs=t_inv), HVec(p, limbs=w_inv),
                        HVec(p, limbs=t_plus_r), HVec(p, limbs=w_plus_r))

            T_row, W_row = hash_vecs_l(mem_row, addr_row, L_row)
            T_col, W_col = hash_vecs_l(mem_col, addr_col, L_col)
            ti_r, wi_r, t_r, w_r = helper_l(T_row, W_row, ts_row)
            ti_c, wi_c, t_c, w_c = helper_l(T_col, W_col, ts_col)
            comms = [CE.commit(ck, v, 0) for v in (ti_r, wi_r, ti_c, wi_c)]
            return comms, [ti_r, wi_r, ti_c, wi_c], [t_r, w_r, t_c, w_c]

        def hash_vecs(mem, addr, lookups):
            T = [(mem[i] * gamma + i) % p for i in range(len(mem))]
            W = [(lk * gamma + ad) % p for ad, lk in zip(addr, lookups)]
            return T, W

        T_row, W_row = hash_vecs(mem_row, addr_row, L_row)
        T_col, W_col = hash_vecs(mem_col, addr_col, L_col)

        def helper(T, W, TS):
            both = [(e + r) % p for e in T] + [(e + r) % p for e in W]
            inv = batch_invert(field, both)
            t_plus_r, w_plus_r = both[: len(T)], both[len(T):]
            t_inv, w_inv = inv[: len(T)], inv[len(T):]
            t_inv = [a * b % p for a, b in zip(t_inv, TS)]
            return t_inv, w_inv, t_plus_r, w_plus_r

        ti_r, wi_r, t_r, w_r = helper(T_row, W_row, ts_row)
        ti_c, wi_c, t_c, w_c = helper(T_col, W_col, ts_col)

        comms = [CE.commit(ck, v, 0) for v in (ti_r, wi_r, ti_c, wi_c)]
        return comms, [ti_r, wi_r, ti_c, wi_c], [t_r, w_r, t_c, w_c]

    def initial_claims(self):
        return [0] * 6

    def size(self):
        return len(self.t_plus_r_row)

    def _linear(self, A, B):
        p = self.field.p
        if native.available() and len(A) >= NATIVE_MIN:
            e0, em1 = native.sumcheck_linear_round_l(p, A.to_limbs(), B.to_limbs())
            return [e0, 0, em1]
        half = len(A) // 2
        e0 = em1 = 0
        AZ, BZ = A.Z, B.Z
        for i in range(half):
            e0 += AZ[i] - BZ[i]
            em1 += (2 * AZ[i] - AZ[half + i]) - (2 * BZ[i] - BZ[half + i])
        return [e0 % p, 0, em1 % p]

    def _cubic_eq(self, A, B, C_const, C=None):
        """sum eq*(A*B - C); C either a poly or the constant C_const."""
        p = self.field.p
        if native.available() and len(A) >= NATIVE_MIN:
            if C is not None:
                Cl = C.to_limbs()
            else:
                Cl = np.zeros((len(A), 4), dtype=np.uint64)
                if C_const:
                    Cl[:, 0] = C_const  # small constants only (0 or 1 here)
            e0, c3, em1 = native.sumcheck_cubic_round_l(
                p, self.poly_eq.to_limbs(), A.to_limbs(), B.to_limbs(), Cl
            )
            return [e0, c3, em1]
        half = len(A) // 2
        e0 = c3 = em1 = 0
        EZ, AZ, BZ = self.poly_eq.Z, A.Z, B.Z
        for i in range(half):
            elo, ehi = EZ[i], EZ[half + i]
            alo, ahi = AZ[i], AZ[half + i]
            blo, bhi = BZ[i], BZ[half + i]
            if C is not None:
                clo, chi = C.Z[i], C.Z[half + i]
            else:
                clo = chi = C_const
            de, da, db, dc = ehi - elo, ahi - alo, bhi - blo, chi - clo
            e0 += elo * (alo * blo - clo)
            c3 += de * da * db
            em1 += (elo - de) * ((alo - da) * (blo - db) - (clo - dc))
        return [e0 % p, c3 % p, em1 % p]

    def evaluation_points(self):
        return [
            self._linear(self.t_plus_r_inv_row, self.w_plus_r_inv_row),
            self._linear(self.t_plus_r_inv_col, self.w_plus_r_inv_col),
            self._cubic_eq(self.t_plus_r_inv_row, self.t_plus_r_row, 0, self.ts_row),
            self._cubic_eq(self.w_plus_r_inv_row, self.w_plus_r_row, 1),
            self._cubic_eq(self.t_plus_r_inv_col, self.t_plus_r_col, 0, self.ts_col),
            self._cubic_eq(self.w_plus_r_inv_col, self.w_plus_r_col, 1),
        ]

    def bound(self, r):
        for pl in (
            self.t_plus_r_row, self.t_plus_r_inv_row, self.w_plus_r_row,
            self.w_plus_r_inv_row, self.ts_row, self.t_plus_r_col,
            self.t_plus_r_inv_col, self.w_plus_r_col, self.w_plus_r_inv_col,
            self.ts_col, self.poly_eq,
        ):
            pl.bind_poly_var_top(r)

    def final_claims(self):
        return [
            [self.t_plus_r_inv_row.Z[0], self.w_plus_r_inv_row.Z[0], self.ts_row.Z[0]],
            [self.t_plus_r_inv_col.Z[0], self.w_plus_r_inv_col.Z[0], self.ts_col.Z[0]],
        ]


class InnerBatchedSumcheckInstance:
    """(a) claim = sum L_row*L_col*val; (b) claim_E = sum eq(r_outer_full)*E
    (ppsnark.rs:693-788)."""

    def __init__(self, field, claim, L_row, L_col, val, claim_E, r_outer_full, E_vec):
        self.field = field
        self.claim = claim % field.p
        self.claim_E = claim_E % field.p

        def M(v):
            return MultilinearPolynomial(field, v)

        self.poly_L_row = M(L_row)
        self.poly_L_col = M(L_col)
        self.poly_val = M(val)
        self.poly_E = M(E_vec)
        self.poly_eq = M(EqPolynomial.evals_hvec(field, list(r_outer_full)))

    def initial_claims(self):
        return [self.claim, self.claim_E]

    def size(self):
        return len(self.poly_L_row)

    def evaluation_points(self):
        p = self.field.p
        if native.available() and len(self.poly_L_row) >= NATIVE_MIN:
            e0, c3, em1 = native.sumcheck_cubicprod_round_l(
                p, self.poly_L_row.to_limbs(), self.poly_L_col.to_limbs(),
                self.poly_val.to_limbs()
            )
            eE0, eEm1 = native.sumcheck_quadeval_round_l(
                p, self.poly_eq.to_limbs(), self.poly_E.to_limbs()
            )
            return [[e0, c3, em1], [eE0, 0, eEm1]]
        half = len(self.poly_L_row) // 2
        AZ, BZ, CZ = self.poly_L_row.Z, self.poly_L_col.Z, self.poly_val.Z
        e0 = c3 = em1 = 0
        for i in range(half):
            alo, ahi = AZ[i], AZ[half + i]
            blo, bhi = BZ[i], BZ[half + i]
            clo, chi = CZ[i], CZ[half + i]
            da, db, dc = ahi - alo, bhi - blo, chi - clo
            e0 += alo * blo % p * clo
            c3 += da * db % p * dc
            em1 += (alo - da) * (blo - db) % p * (clo - dc)
        eE0 = eEm1 = 0
        EZ, QZ = self.poly_E.Z, self.poly_eq.Z
        for i in range(half):
            elo, ehi = EZ[i], EZ[half + i]
            qlo, qhi = QZ[i], QZ[half + i]
            eE0 += qlo * elo
            eEm1 += (2 * qlo - qhi) * (2 * elo - ehi)
        return [[e0 % p, c3 % p, em1 % p], [eE0 % p, 0, eEm1 % p]]

    def bound(self, r):
        for pl in (self.poly_L_row, self.poly_L_col, self.poly_val, self.poly_E,
                   self.poly_eq):
            pl.bind_poly_var_top(r)

    def final_claims(self):
        return [
            [self.poly_L_row.Z[0], self.poly_L_col.Z[0]],
            [self.poly_E.Z[0]],
        ]


def _prove_helper(field, mem, inner, witness, transcript):
    """Joint RLC sumcheck over the 3 engines (ppsnark.rs:886-983)."""
    p = field.p
    assert mem.size() == inner.size() == witness.size()
    claims = mem.initial_claims() + inner.initial_claims() + witness.initial_claims()

    s = transcript.squeeze(b"r")
    coeffs = powers(field, s, len(claims))
    e = sum(c * co for c, co in zip(claims, coeffs)) % p

    r: List[int] = []
    cubic_polys = []
    for _ in range(log2_int(mem.size())):
        evals = mem.evaluation_points() + inner.evaluation_points() + witness.evaluation_points()
        assert len(evals) == len(claims)
        e0 = sum(ev[0] * co for ev, co in zip(evals, coeffs)) % p
        c3 = sum(ev[1] * co for ev, co in zip(evals, coeffs)) % p
        einf = sum(ev[2] * co for ev, co in zip(evals, coeffs)) % p
        poly = UniPoly.from_evals_deg3(field, [e0, (e - e0) % p, c3, einf])
        transcript.absorb(b"p", poly)
        r_i = transcript.squeeze(b"c")
        r.append(r_i)
        mem.bound(r_i)
        inner.bound(r_i)
        witness.bound(r_i)
        e = poly.evaluate(r_i)
        cubic_polys.append(poly.compress())

    return (
        SumcheckProof(cubic_polys), r,
        mem.final_claims(), inner.final_claims(), witness.final_claims(),
    )


# ---------------------------------------------------------------------------
# keys + the SNARK
# ---------------------------------------------------------------------------

@dataclass
class PPProverKey:
    ee_pk: object
    S_repr: R1CSShapeSparkRepr
    S_comm: R1CSShapeSparkCommitment
    vk_digest: int
    ee: object = None


class PPVerifierKey:
    def __init__(self, engine, num_cons, num_vars, S_comm, ee_vk, ee=None):
        self.engine = engine
        self.num_cons = num_cons
        self.num_vars = num_vars
        self.S_comm = S_comm
        self.ee_vk = ee_vk
        self.ee = ee
        self._digest = None

    def digest(self) -> int:
        if self._digest is None:
            h = hashlib.sha3_256()
            h.update(b"nova_tpu.PPVerifierKey")  # the protocol's domain tag, shared with nova_tpu
            h.update(_u64(self.num_cons))
            h.update(_u64(self.num_vars))
            h.update(_u64(self.S_comm.N))
            h.update(self.S_comm.to_transcript_bytes())
            self._digest = map_to_field(h.digest(), self.engine.scalar)
        return self._digest


class RelaxedR1CSSNARK:
    """MicroSpartan (ppsnark.rs:818-1660)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @staticmethod
    def ck_floor(S) -> int:
        return S.A.nnz + S.B.nnz + S.C.nnz

    @staticmethod
    def setup(engine, ck, S, ee=None):
        ee = ee or _default_ee()
        if len(ck) < RelaxedR1CSSNARK.ck_floor(S):
            raise InvalidCommitmentKeyLengthError()
        ee_pk, ee_vk = ee.setup(engine, ck)
        S = S.pad()
        S_repr = R1CSShapeSparkRepr(S)
        S_comm = S_repr.commit(ck)
        vk = PPVerifierKey(engine, S.num_cons, S.num_vars, S_comm, ee_vk, ee)
        pk = PPProverKey(ee_pk, S_repr, S_comm, vk.digest(), ee)
        return pk, vk

    @staticmethod
    def prove(engine, ck, pk: PPProverKey, S, U, W, ee=None) -> "RelaxedR1CSSNARK":
        ee = ee or pk.ee or _default_ee()
        field = engine.scalar
        p = field.p

        S = S.pad()
        assert S.is_regular_shape()
        W = W.pad(S)

        transcript = engine.new_transcript(b"RelaxedR1CSSNARK")
        transcript.absorb(b"vk", field.to_repr(pk.vk_digest))
        transcript.absorb(b"U", U.to_transcript_bytes(field))

        z = list(W.W) + [U.u] + list(U.X)
        S_repr = pk.S_repr
        num_rounds_outer = log2_int(S.num_cons)
        num_rounds_inner = log2_int(S_repr.N)
        tau = [transcript.squeeze(b"t") for _ in range(num_rounds_outer)]

        with profiling.phase("pp_outer"):
            Az, Bz, Cz, uCz_E = _outer_tables(field, S, U, W, ck.device)
            sc_outer, r_outer, claims_outer = _prove_outer(
                field, S, tau, Az, Bz, uCz_E, transcript, ck.device)
            eval_Az = claims_outer[0]
            eval_Bz = claims_outer[1]
            eval_Cz = MultilinearPolynomial.evaluate_with(field, Cz, r_outer)
            eval_E_at_r_outer = (claims_outer[2] - U.u * eval_Cz) % p
        transcript.absorb(
            b"e", _scalars(field, [eval_Az, eval_Bz, eval_Cz, eval_E_at_r_outer])
        )

        with profiling.phase("pp_oracles"):
            num_pad = num_rounds_inner - num_rounds_outer
            r_pad = [transcript.squeeze(b"p") for _ in range(num_pad)]
            r_outer_full = list(r_pad) + list(r_outer)
            factor = 1
            for rp in r_pad:
                factor = factor * (1 - rp) % p

            E_pad = padded(W.E, S_repr.N)
            W_pad = padded(W.W, S_repr.N)

            mem_row, mem_col, L_row, L_col = S_repr.evaluation_oracles(S, r_outer_full, z)
            comm_L_row = CE.commit(ck, L_row, 0)
            comm_L_col = CE.commit(ck, L_col, 0)
            transcript.absorb(b"e", _comms([comm_L_row, comm_L_col]))

            c = transcript.squeeze(b"c")
            gamma = transcript.squeeze(b"g")
            r = transcript.squeeze(b"r")

            c_sq = c * c % p
            val = [(va + c * vb + c_sq * vc) % p
                   for va, vb, vc in zip(S_repr.val_A, S_repr.val_B, S_repr.val_C)]
            inner_sc = InnerBatchedSumcheckInstance(
                field,
                factor * ((eval_Az + c * eval_Bz + c_sq * eval_Cz) % p) % p,
                list(L_row),
                list(L_col),
                val,
                factor * eval_E_at_r_outer % p,
                r_outer_full,
                list(E_pad),
            )

            comm_mem_oracles, mem_oracles, mem_aux = MemorySumcheckInstance.compute_oracles(
                field, ck, r, gamma,
                mem_row, S_repr.row, L_row, S_repr.ts_row,
                mem_col, S_repr.col, L_col, S_repr.ts_col,
            )
            transcript.absorb(b"l", _comms(comm_mem_oracles))
            rho = [transcript.squeeze(b"r") for _ in range(num_rounds_inner)]

        with profiling.phase("pp_inner"):
            mem_sc = MemorySumcheckInstance(
                field, [list(v) for v in mem_oracles], mem_aux, rho,
                S_repr.ts_row, S_repr.ts_col,
            )
            witness_sc = WitnessBoundSumcheck(field, r_outer_full, list(W_pad), S.num_vars)

            sc_inner, r_inner, claims_mem, claims_inner, claims_witness = _prove_helper(
                field, mem_sc, inner_sc, witness_sc, transcript
            )

            eval_L_row = claims_inner[0][0]
            eval_L_col = claims_inner[0][1]
            eval_E = claims_inner[1][0]
            eval_t_inv_row, eval_w_inv_row, eval_ts_row = claims_mem[0]
            eval_t_inv_col, eval_w_inv_col, eval_ts_col = claims_mem[1]
            eval_W = claims_witness[0][0]

            eval_val_A, eval_val_B, eval_val_C, eval_row, eval_col = (
                MultilinearPolynomial.evaluate_with(field, v, r_inner)
                for v in (S_repr.val_A, S_repr.val_B, S_repr.val_C, S_repr.row, S_repr.col)
            )

        with profiling.phase("pp_ee"):
            eval_vec = [
                eval_W, eval_E, eval_L_row, eval_L_col,
                eval_val_A, eval_val_B, eval_val_C,
                eval_t_inv_row, eval_row, eval_w_inv_row, eval_ts_row,
                eval_t_inv_col, eval_col, eval_w_inv_col, eval_ts_col,
            ]
            comm_vec = [
                U.comm_W, U.comm_E, comm_L_row, comm_L_col,
                pk.S_comm.comm_val_A, pk.S_comm.comm_val_B, pk.S_comm.comm_val_C,
                comm_mem_oracles[0], pk.S_comm.comm_row, comm_mem_oracles[1],
                pk.S_comm.comm_ts_row, comm_mem_oracles[2], pk.S_comm.comm_col,
                comm_mem_oracles[3], pk.S_comm.comm_ts_col,
            ]
            poly_vec = [
                W_pad, E_pad, L_row, L_col,
                S_repr.val_A, S_repr.val_B, S_repr.val_C,
                mem_oracles[0], S_repr.row, mem_oracles[1], S_repr.ts_row,
                mem_oracles[2], S_repr.col, mem_oracles[3], S_repr.ts_col,
            ]
            transcript.absorb(b"e", _scalars(field, eval_vec))
            c2 = transcript.squeeze(b"c")
            w_joint = PolyEvalWitness.batch(field, [list(v) for v in poly_vec], c2)
            u_joint = PolyEvalInstance.batch(field, comm_vec, r_inner, eval_vec, c2)

            eval_arg = ee.prove(
                engine, ck, pk.ee_pk, transcript, u_joint.c, w_joint.p, list(r_inner),
                u_joint.e
            )

        return RelaxedR1CSSNARK(
            comm_L_row=comm_L_row,
            comm_L_col=comm_L_col,
            comm_t_plus_r_inv_row=comm_mem_oracles[0],
            comm_w_plus_r_inv_row=comm_mem_oracles[1],
            comm_t_plus_r_inv_col=comm_mem_oracles[2],
            comm_w_plus_r_inv_col=comm_mem_oracles[3],
            sc_outer=sc_outer,
            eval_Az_at_r_outer=eval_Az,
            eval_Bz_at_r_outer=eval_Bz,
            eval_Cz_at_r_outer=eval_Cz,
            eval_E_at_r_outer=eval_E_at_r_outer,
            sc_inner_batched=sc_inner,
            eval_E=eval_E,
            eval_L_row=eval_L_row,
            eval_L_col=eval_L_col,
            eval_val_A=eval_val_A,
            eval_val_B=eval_val_B,
            eval_val_C=eval_val_C,
            eval_W=eval_W,
            eval_t_plus_r_inv_row=eval_t_inv_row,
            eval_row=eval_row,
            eval_w_plus_r_inv_row=eval_w_inv_row,
            eval_ts_row=eval_ts_row,
            eval_t_plus_r_inv_col=eval_t_inv_col,
            eval_col=eval_col,
            eval_w_plus_r_inv_col=eval_w_inv_col,
            eval_ts_col=eval_ts_col,
            eval_arg=eval_arg,
        )

    def verify(self, vk: PPVerifierKey, U, ee=None) -> None:
        ee = ee or vk.ee or _default_ee()
        engine = vk.engine
        field = engine.scalar
        p = field.p

        transcript = engine.new_transcript(b"RelaxedR1CSSNARK")
        transcript.absorb(b"vk", field.to_repr(vk.digest()))
        transcript.absorb(b"U", U.to_transcript_bytes(field))

        num_rounds_outer = log2_int(vk.num_cons)
        num_rounds_inner = log2_int(vk.S_comm.N)
        tau = [transcript.squeeze(b"t") for _ in range(num_rounds_outer)]

        claim_outer_final, r_outer = self.sc_outer.verify(
            field, 0, num_rounds_outer, 3, transcript
        )
        eq_tau = EqPolynomial(field, tau).evaluate(r_outer)
        expected = eq_tau * (
            (self.eval_Az_at_r_outer * self.eval_Bz_at_r_outer
             - U.u * self.eval_Cz_at_r_outer
             - self.eval_E_at_r_outer) % p
        ) % p
        if expected != claim_outer_final:
            raise InvalidSumcheckProofError()

        transcript.absorb(
            b"e",
            _scalars(field, [
                self.eval_Az_at_r_outer, self.eval_Bz_at_r_outer,
                self.eval_Cz_at_r_outer, self.eval_E_at_r_outer,
            ]),
        )

        num_pad = num_rounds_inner - num_rounds_outer
        r_pad = [transcript.squeeze(b"p") for _ in range(num_pad)]
        r_outer_full = list(r_pad) + list(r_outer)
        factor = 1
        for rp in r_pad:
            factor = factor * (1 - rp) % p

        transcript.absorb(b"e", _comms([self.comm_L_row, self.comm_L_col]))
        c = transcript.squeeze(b"c")
        gamma = transcript.squeeze(b"g")
        r = transcript.squeeze(b"r")
        transcript.absorb(
            b"l",
            _comms([
                self.comm_t_plus_r_inv_row, self.comm_w_plus_r_inv_row,
                self.comm_t_plus_r_inv_col, self.comm_w_plus_r_inv_col,
            ]),
        )
        rho = [transcript.squeeze(b"r") for _ in range(num_rounds_inner)]

        num_claims = 9
        s = transcript.squeeze(b"r")
        coeffs = powers(field, s, num_claims)
        claim_ABC = factor * (
            (self.eval_Az_at_r_outer + c * self.eval_Bz_at_r_outer
             + c * c % p * self.eval_Cz_at_r_outer) % p
        ) % p
        claim = (coeffs[6] * claim_ABC + coeffs[7] * factor % p * self.eval_E_at_r_outer) % p

        claim_inner_final, r_inner = self.sc_inner_batched.verify(
            field, claim, num_rounds_inner, 3, transcript
        )

        rand_eq = EqPolynomial(field, rho).evaluate(r_inner)
        eq_r_outer = EqPolynomial(field, r_outer_full)
        eq_ro_at_ri = eq_r_outer.evaluate(r_inner)
        taus_masked = MaskedEqPolynomial(eq_r_outer, log2_int(vk.num_vars)).evaluate(r_inner)

        ident = IdentityPolynomial(field, num_rounds_inner).evaluate(r_inner)
        eval_t_plus_r_row = (ident + gamma * eq_ro_at_ri + r) % p
        eval_w_plus_r_row = (self.eval_row + gamma * self.eval_L_row + r) % p

        # eval of z at the unpadded inner point
        l = num_rounds_inner - log2_int(2 * vk.num_vars)
        factor2 = 1
        for rp in r_inner[:l]:
            factor2 = factor2 * (1 - rp) % p
        r_unpad = r_inner[l:]
        X = [U.u] + list(U.X)
        eval_X = SparsePolynomial(field, len(r_unpad) - 1, X).evaluate(r_unpad[1:])
        eval_val_col = (self.eval_W + factor2 * r_unpad[0] % p * eval_X) % p
        eval_t_plus_r_col = (ident + gamma * eval_val_col + r) % p
        eval_w_plus_r_col = (self.eval_col + gamma * self.eval_L_col + r) % p

        claim_mem = (
            coeffs[0] * ((self.eval_t_plus_r_inv_row - self.eval_w_plus_r_inv_row) % p)
            + coeffs[1] * ((self.eval_t_plus_r_inv_col - self.eval_w_plus_r_inv_col) % p)
            + coeffs[2] * (rand_eq * ((self.eval_t_plus_r_inv_row * eval_t_plus_r_row
                                       - self.eval_ts_row) % p) % p)
            + coeffs[3] * (rand_eq * ((self.eval_w_plus_r_inv_row * eval_w_plus_r_row
                                       - 1) % p) % p)
            + coeffs[4] * (rand_eq * ((self.eval_t_plus_r_inv_col * eval_t_plus_r_col
                                       - self.eval_ts_col) % p) % p)
            + coeffs[5] * (rand_eq * ((self.eval_w_plus_r_inv_col * eval_w_plus_r_col
                                       - 1) % p) % p)
        ) % p
        claim_ABC_final = coeffs[6] * self.eval_L_row % p * self.eval_L_col % p * (
            (self.eval_val_A + c * self.eval_val_B + c * c % p * self.eval_val_C) % p
        ) % p
        claim_E_final = coeffs[7] * eq_ro_at_ri % p * self.eval_E % p
        claim_witness_final = coeffs[8] * taus_masked % p * self.eval_W % p

        expected_inner = (claim_mem + claim_ABC_final + claim_E_final
                          + claim_witness_final) % p
        if expected_inner != claim_inner_final:
            raise InvalidSumcheckProofError()

        eval_vec = [
            self.eval_W, self.eval_E, self.eval_L_row, self.eval_L_col,
            self.eval_val_A, self.eval_val_B, self.eval_val_C,
            self.eval_t_plus_r_inv_row, self.eval_row, self.eval_w_plus_r_inv_row,
            self.eval_ts_row, self.eval_t_plus_r_inv_col, self.eval_col,
            self.eval_w_plus_r_inv_col, self.eval_ts_col,
        ]
        comm_vec = [
            U.comm_W, U.comm_E, self.comm_L_row, self.comm_L_col,
            vk.S_comm.comm_val_A, vk.S_comm.comm_val_B, vk.S_comm.comm_val_C,
            self.comm_t_plus_r_inv_row, vk.S_comm.comm_row,
            self.comm_w_plus_r_inv_row, vk.S_comm.comm_ts_row,
            self.comm_t_plus_r_inv_col, vk.S_comm.comm_col,
            self.comm_w_plus_r_inv_col, vk.S_comm.comm_ts_col,
        ]
        transcript.absorb(b"e", _scalars(field, eval_vec))
        c2 = transcript.squeeze(b"c")
        u_joint = PolyEvalInstance.batch(field, comm_vec, r_inner, eval_vec, c2)

        ee.verify(
            engine, vk.ee_vk, transcript, u_joint.c, list(r_inner), u_joint.e, self.eval_arg
        )


def _default_ee():
    from nova_tpu_torch.provider.ipa import EvaluationEngine

    return EvaluationEngine
