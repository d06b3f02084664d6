"""R1CS data model + Relaxed-R1CS folding math (port of
``nova_tpu/r1cs/__init__.py``; reference: src/r1cs/).

Vectors are Python-int lists or device-resident FVecs at this level; the
heavy lifting (SpMV over big shapes, commitments, folds over long vectors)
goes to :mod:`nova_tpu_torch.ops` at or above DEVICE_THRESHOLD /
FOLD_DEVICE_THRESHOLD, on the commitment key's device (or the device of the
FVecs folded). At or above FOLD_DEVICE_THRESHOLD rows a fold's cross-term
is computed on the device, square shape or not, and its vectors stay there
from the cross-term to the folded witness (the JAX package computes a
non-square cross-term natively on the host). Below DEVICE_THRESHOLD the
satisfiability checks and the cross-term run in the native host binding on
limb arrays, as in the JAX package; without the binding they keep its
pure-Python branches. At or above it the satisfiability checks keep the
device SpMV and the device MSM, also for a shape that is not square.

z layout everywhere: z = [W (num_vars), u, X (num_io)]
(src/r1cs/mod.rs:459,504).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from nova_tpu_torch import constants, native, profiling
from nova_tpu_torch.constants import BN_LIMB_WIDTH, BN_N_LIMBS
from nova_tpu_torch.errors import (
    InvalidIndexError,
    InvalidInputLengthError,
    InvalidWitnessLengthError,
    UnSatError,
)
from nova_tpu_torch.fields.spec import FieldSpec
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine, CommitmentKey, DerandKey


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class SparseMatrix:
    """CSR sparse matrix over a prime field (src/r1cs/sparse.rs:13-40).

    data/indices/indptr follow scipy/CSR conventions; `cols` is the total
    column count.
    """

    __slots__ = ("field", "data", "indices", "indptr", "cols", "_native_cache")

    def __init__(self, field: FieldSpec, data, indices, indptr, cols):
        self.field = field
        self.data = list(data)
        self.indices = list(indices)
        self.indptr = list(indptr)
        self.cols = cols
        self._native_cache = None

    @staticmethod
    def new(field: FieldSpec, triples: Sequence[Tuple[int, int, int]], rows: int, cols: int):
        """Build from (row, col, val) triples (SparseMatrix::new)."""
        triples = sorted(triples, key=lambda t: (t[0], t[1]))
        data, indices, indptr = [], [], [0]
        r = 0
        for row, col, val in triples:
            assert row < rows and col < cols
            while r < row:
                indptr.append(len(data))
                r += 1
            data.append(val % field.p)
            indices.append(col)
        while r < rows:
            indptr.append(len(data))
            r += 1
        return SparseMatrix(field, data, indices, indptr, cols)

    @property
    def rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.data)

    def iter_triples(self):
        for r in range(self.rows):
            for k in range(self.indptr[r], self.indptr[r + 1]):
                yield (r, self.indices[k], self.data[k])

    def native_cache(self):
        """Marshalled rep for the native SpMV kernel, built once."""
        if self._native_cache is None:
            self._native_cache = native.marshal_matrix(
                self.field.p, self.data, self.indices, self.indptr
            )
        return self._native_cache

    def multiply_vec_l(self, z):
        """SpMV on (n, 4) uint64 limb arrays via the native kernel."""
        return native.spmv_l(self.field.p, self.native_cache(), z)

    def multiply_vec(self, z: Sequence[int]) -> List[int]:
        if native.available() and self.nnz > 512:
            zl = native.ints_to_limbs([x % self.field.p for x in z])
            return native.limbs_to_ints(self.multiply_vec_l(zl))
        p = self.field.p
        out = []
        data, indices, indptr = self.data, self.indices, self.indptr
        for r in range(self.rows):
            acc = 0
            for k in range(indptr[r], indptr[r + 1]):
                acc += data[k] * z[indices[k]]
            out.append(acc % p)
        return out

    def multiply_vec_transpose(self, v: Sequence[int]) -> List[int]:
        """Computes M^T v (needed by Spartan's eval-table builder)."""
        p = self.field.p
        out = [0] * self.cols
        for r in range(self.rows):
            vr = v[r]
            if vr == 0:
                continue
            for k in range(self.indptr[r], self.indptr[r + 1]):
                out[self.indices[k]] = (out[self.indices[k]] + self.data[k] * vr) % p
        return out

    def __eq__(self, other):
        return (
            self.data == other.data
            and self.indices == other.indices
            and self.indptr == other.indptr
            and self.cols == other.cols
        )


def _vec_limbs(v, p):
    """(n, 4) uint64 normal-form limbs of a vector (FVec/HVec or ints)."""
    from nova_tpu_torch.ops.fvec import FVec, HVec

    if isinstance(v, (FVec, HVec)):
        return v.limbs64()
    return native.ints_to_limbs([x % p for x in v])


def _vec_device(*vs):
    """The device of the first FVec among `vs` (None: the default, CUDA)."""
    from nova_tpu_torch.ops.fvec import FVec

    for v in vs:
        if isinstance(v, FVec):
            return v.device
    return None


@dataclass
class R1CSShape:
    """The shape (A, B, C, dims) of an R1CS (src/r1cs/mod.rs:31-47)."""

    field: FieldSpec
    num_cons: int
    num_vars: int
    num_io: int
    A: SparseMatrix
    B: SparseMatrix
    C: SparseMatrix
    _digest: Optional[int] = None

    @staticmethod
    def new(field, num_cons, num_vars, num_io, A, B, C) -> "R1CSShape":
        for M in (A, B, C):
            for row, col, _ in M.iter_triples():
                if row >= num_cons or col > num_io + num_vars:
                    raise InvalidIndexError()
        return R1CSShape(field, num_cons, num_vars, num_io, A, B, C)

    # --- digest ---
    def digest(self) -> int:
        if self._digest is None:
            from nova_tpu_torch.digest import DigestComputer

            self._digest = DigestComputer.digest_shape(self)
        return self._digest

    def is_regular_shape(self) -> bool:
        return (
            _next_pow2(self.num_cons) == self.num_cons
            and _next_pow2(self.num_vars) == self.num_vars
            and self.num_io < self.num_vars
        )

    # --- SpMV ---
    def multiply_vec_l(self, zl):
        """(Az, Bz, Cz) on (n, 4) uint64 limbs via the native kernels."""
        return (
            self.A.multiply_vec_l(zl),
            self.B.multiply_vec_l(zl),
            self.C.multiply_vec_l(zl),
        )

    def multiply_vec(self, z: Sequence[int], device=None):
        """(Az, Bz, Cz) as int lists; on `device` (CUDA unless given) at or
        above DEVICE_THRESHOLD constraints."""
        if len(z) != self.num_io + self.num_vars + 1:
            raise InvalidWitnessLengthError()
        if self.num_cons >= constants.DEVICE_THRESHOLD:
            from nova_tpu_torch.ops.spmv import multiply_vec_device

            return multiply_vec_device(self, z, device)
        return (
            self.A.multiply_vec(z),
            self.B.multiply_vec(z),
            self.C.multiply_vec(z),
        )

    def _host_native(self) -> bool:
        """The satisfiability checks and the cross-term take the native host
        binding: below DEVICE_THRESHOLD, where the SpMV stays on the host."""
        return self.num_cons < constants.DEVICE_THRESHOLD and native.available()

    # --- satisfiability ---
    def _sat_limbs(self, W, u: int, X, E=None) -> int:
        """Rows of the native residual check Az*Bz - u*Cz - E != 0 (E = 0
        when None), on z = [W, u, X] as limbs."""
        import numpy as np

        p = self.field.p
        zl = np.vstack([_vec_limbs(W, p), native.ints_to_limbs([u % p] + [x % p for x in X])])
        Az, Bz, Cz = self.multiply_vec_l(zl)
        El = np.zeros_like(Az) if E is None else _vec_limbs(E, p)
        return native.vec_sat_check_l(p, Az, Bz, Cz, El, u)

    def is_sat_relaxed(self, ck: CommitmentKey, U: "RelaxedR1CSInstance", W: "RelaxedR1CSWitness"):
        assert len(W.W) == self.num_vars
        assert len(W.E) == self.num_cons
        assert len(U.X) == self.num_io
        p = self.field.p
        if self._host_native():
            if self._sat_limbs(W.W, U.u, U.X, W.E):
                raise UnSatError("Relaxed R1CS is unsatisfiable")
        else:
            from nova_tpu_torch.ops.fvec import as_list

            z = as_list(W.W) + [U.u] + list(U.X)
            Az, Bz, Cz = self.multiply_vec(z, ck.device)
            E = as_list(W.E)
            for i in range(self.num_cons):
                if Az[i] * Bz[i] % p != (U.u * Cz[i] + E[i]) % p:
                    raise UnSatError("Relaxed R1CS is unsatisfiable")
        comm_W = CommitmentEngine.commit(ck, W.W, W.r_W)
        comm_E = CommitmentEngine.commit(ck, W.E, W.r_E)
        if U.comm_W != comm_W or U.comm_E != comm_E:
            raise UnSatError("Invalid commitments")

    def is_sat(self, ck: CommitmentKey, U: "R1CSInstance", W: "R1CSWitness"):
        assert len(W.W) == self.num_vars
        assert len(U.X) == self.num_io
        p = self.field.p
        if self._host_native():
            if self._sat_limbs(W.W, 1, U.X):
                raise UnSatError("R1CS is unsatisfiable")
        else:
            from nova_tpu_torch.ops.fvec import as_list

            z = as_list(W.W) + [1] + list(U.X)
            Az, Bz, Cz = self.multiply_vec(z, ck.device)
            for i in range(self.num_cons):
                if Az[i] * Bz[i] % p != Cz[i]:
                    raise UnSatError("R1CS is unsatisfiable")
        if U.comm_W != CommitmentEngine.commit(ck, W.W, W.r_W):
            raise UnSatError("Invalid commitment")

    def _fold_on_device(self) -> bool:
        """The cross-term runs on the device (ops/fold.commit_T_device) at or
        above FOLD_DEVICE_THRESHOLD rows, whether the shape is square or
        not."""
        return self.num_cons >= constants.FOLD_DEVICE_THRESHOLD

    def _commit_T_limbs(self, ck, U1, W1, U2, W2, r_T, u: int, E2=None):
        """Host-native cross-term T = Az*Bz - u*Cz - E (E = W1.E, plus W2.E
        when relaxed) on Z = [W1.W + W2.W, u, U1.X + U2.X], committed from
        its limbs; T comes back as an HVec."""
        import numpy as np

        from nova_tpu_torch.ops.fvec import HVec

        p = self.field.p
        with profiling.phase("nifs.cross_term"):
            Wsum = native.vec_addmod_l(p, _vec_limbs(W1.W, p), _vec_limbs(W2.W, p))
            tail = [u] + [(x1 + x2) % p for x1, x2 in zip(U1.X, U2.X)]
            Az, Bz, Cz = self.multiply_vec_l(np.vstack([Wsum, native.ints_to_limbs(tail)]))
            E = _vec_limbs(W1.E, p)
            if E2 is not None:
                E = native.vec_addmod_l(p, E, _vec_limbs(E2, p))
            Tl = native.vec_cross_l(p, Az, Bz, Cz, E, u)
        with profiling.phase("nifs.commit_T"):
            return HVec(p, limbs=Tl), CommitmentEngine.commit_limbs(ck, Tl, r_T)

    # --- folding cross-term (src/r1cs/mod.rs:533-619, Mova §5.2 trick) ---
    def cross_term(self, ck, U1, W1, U2, W2, r_T, relaxed: bool):
        """(T, comm_T, W2) for folding (U2, W2) into (U1, W1): T = Az*Bz -
        u*Cz - E1 (- E2 when relaxed) on Z = [W1.W + W2.W, u, U1.X + U2.X],
        u = U1.u + 1 (U1.u + U2.u when relaxed), and W2 as the witness fold
        should read it.

        At or above FOLD_DEVICE_THRESHOLD rows T is computed on the device
        and is an FVec; W2's vectors cross to the device once, here, and the
        W2 returned holds them as FVecs, so the fold does not convert them
        again. Otherwise W2 comes back as given: below DEVICE_THRESHOLD T is
        computed by the native binding on limbs (an HVec), else on int lists
        (around the device SpMV at or above DEVICE_THRESHOLD)."""
        p = self.field.p
        u = (U1.u + (U2.u if relaxed else 1)) % p
        if self._fold_on_device():
            from nova_tpu_torch.ops.fold import commit_T_device, fold_device, witness_on_device

            profiling.count("nifs.cross_term_rows.device", self.num_cons)
            with profiling.phase("nifs.cross_term"):
                W2 = witness_on_device(self.field, W2, fold_device(W1, ck.device))
                T = commit_T_device(self, U1, W1, U2, W2, relaxed, ck.device)
            with profiling.phase("nifs.commit_T"):
                return T, CommitmentEngine.commit(ck, T, r_T), W2
        profiling.count("nifs.cross_term_rows.host", self.num_cons)
        if self._host_native():
            T, comm_T = self._commit_T_limbs(ck, U1, W1, U2, W2, r_T, u,
                                             W2.E if relaxed else None)
            return T, comm_T, W2
        from nova_tpu_torch.ops.fvec import as_list

        with profiling.phase("nifs.cross_term"):
            Z = [(w1 + w2) % p for w1, w2 in zip(as_list(W1.W), as_list(W2.W))]
            Z.append(u)
            Z.extend((x1 + x2) % p for x1, x2 in zip(U1.X, U2.X))
            AZ, BZ, CZ = self.multiply_vec(Z, ck.device)
            E = as_list(W1.E)
            if relaxed:
                E = [e1 + e2 for e1, e2 in zip(E, as_list(W2.E))]
            T = [(az * bz - u * cz - e) % p for az, bz, cz, e in zip(AZ, BZ, CZ, E)]
        with profiling.phase("nifs.commit_T"):
            comm_T = CommitmentEngine.commit(ck, T, r_T)
        return T, comm_T, W2

    def commit_T(self, ck, U1, W1, U2, W2, r_T):
        """(T, comm_T) for folding a plain instance (U2.u = 1, no E2)."""
        return self.cross_term(ck, U1, W1, U2, W2, r_T, False)[:2]

    def commit_T_relaxed(self, ck, U1, W1, U2, W2, r_T):
        """(T, comm_T) for folding a relaxed instance."""
        return self.cross_term(ck, U1, W1, U2, W2, r_T, True)[:2]

    # --- padding (src/r1cs/mod.rs:623-738) ---
    def _apply_pad(self, M: SparseMatrix, num_vars_padded: int, num_cons_padded: int) -> SparseMatrix:
        indices = [
            c + (num_vars_padded - self.num_vars) if c >= self.num_vars else c
            for c in M.indices
        ]
        cols = M.cols + (num_vars_padded - self.num_vars)
        indptr = list(M.indptr) + [M.indptr[-1]] * (num_cons_padded - self.num_cons)
        return SparseMatrix(self.field, M.data, indices, indptr, cols)

    def pad(self) -> "R1CSShape":
        if self.is_regular_shape():
            return self
        cached = getattr(self, "_padded", None)
        if cached is not None:
            return cached
        m = _next_pow2(max(self.num_vars, self.num_cons, self.num_io))
        if self.num_vars == m:
            out = R1CSShape(
                self.field, m, m, self.num_io, self.A, self.B, self.C
            )
        else:
            out = R1CSShape(
                self.field,
                m,
                m,
                self.num_io,
                self._apply_pad(self.A, m, m),
                self._apply_pad(self.B, m, m),
                self._apply_pad(self.C, m, m),
            )
        # memoized: provers pad per call and the padded shape carries its
        # device CSR cache
        self._padded = out
        return out

    def pad_nonsquare(self) -> "R1CSShape":
        if self.is_regular_shape():
            return self
        num_vars_padded = _next_pow2(max(self.num_vars, self.num_io + 1))
        num_cons_padded = _next_pow2(self.num_cons)
        return R1CSShape(
            self.field,
            num_cons_padded,
            num_vars_padded,
            self.num_io,
            self._apply_pad(self.A, num_vars_padded, num_cons_padded),
            self._apply_pad(self.B, num_vars_padded, num_cons_padded),
            self._apply_pad(self.C, num_vars_padded, num_cons_padded),
        )

    def sample_random_instance_witness(self, ck: CommitmentKey):
        """ZK randomizer pair (src/r1cs/mod.rs:741-787)."""
        p = self.field.p
        n = self.num_vars + self.num_io + 1
        Z = [secrets.randbelow(p) for _ in range(n)]
        r_W = secrets.randbelow(p)
        r_E = secrets.randbelow(p)
        u = Z[self.num_vars]
        AZ, BZ, CZ = self.multiply_vec(Z, ck.device)
        E = [(az * bz - u * cz) % p for az, bz, cz in zip(AZ, BZ, CZ)]
        comm_W = CommitmentEngine.commit(ck, Z[: self.num_vars], r_W)
        comm_E = CommitmentEngine.commit(ck, E, r_E)
        inst = RelaxedR1CSInstance(comm_W, comm_E, list(Z[self.num_vars + 1 :]), u)
        wit = RelaxedR1CSWitness(Z[: self.num_vars], r_W, E, r_E)
        return inst, wit

    def commitment_key(self, label: bytes = b"ck", ck_floor: int = 0,
                       device=None) -> CommitmentKey:
        """Key sized max(cons, vars, floor), marshalled for the device MSMs
        on `device` (CUDA unless given)."""
        size = max(self.num_cons, self.num_vars, ck_floor)
        return CommitmentEngine.setup(_commit_curve(self), label, size, device=device)


def _commit_curve(shape: R1CSShape):
    """The curve whose SCALAR field is the shape's field."""
    from nova_tpu_torch.curves.spec import ALL_CURVES

    for c in ALL_CURVES.values():
        if c.scalar.p == shape.field.p:
            return c
    raise ValueError(f"no curve with scalar field {shape.field.name}")


@dataclass
class R1CSWitness:
    W: List[int]
    r_W: int

    @staticmethod
    def new(S: R1CSShape, W: Sequence[int], r_W: Optional[int] = None) -> "R1CSWitness":
        W = list(W) + [0] * (S.num_vars - len(W))
        if r_W is None:
            r_W = secrets.randbelow(S.field.p)
        return R1CSWitness(W, r_W)

    def commit(self, ck: CommitmentKey) -> Commitment:
        return CommitmentEngine.commit(ck, self.W, self.r_W)

    def derandomize(self):
        return R1CSWitness(self.W, 0), self.r_W


@dataclass
class R1CSInstance:
    comm_W: Commitment
    X: List[int]

    @staticmethod
    def new(S: R1CSShape, comm_W: Commitment, X: Sequence[int]) -> "R1CSInstance":
        if S.num_io != len(X):
            raise InvalidInputLengthError()
        return R1CSInstance(comm_W, list(X))

    def to_transcript_bytes(self, field: FieldSpec) -> bytes:
        out = self.comm_W.to_transcript_bytes()
        for x in self.X:
            out += field.to_repr(x)
        return out

    def absorb_in_ro(self, ro):
        """src/r1cs/mod.rs:900-910: comm_W coords then X (bit-copied to base)."""
        self.comm_W.absorb_in_ro(ro)
        for x in self.X:
            ro.absorb(x)

    def absorb_in_ro2(self, ro):
        self.comm_W.absorb_in_ro2(ro)
        for x in self.X:
            ro.absorb(x)

    def derandomize(self, dk: DerandKey, r_W: int) -> "R1CSInstance":
        return R1CSInstance(CommitmentEngine.derandomize(dk, self.comm_W, r_W), list(self.X))


@dataclass
class RelaxedR1CSWitness:
    W: List[int]
    r_W: int
    E: List[int]
    r_E: int

    @staticmethod
    def default(S: R1CSShape) -> "RelaxedR1CSWitness":
        return RelaxedR1CSWitness([0] * S.num_vars, 0, [0] * S.num_cons, 0)

    @staticmethod
    def from_r1cs_witness(S: R1CSShape, witness: R1CSWitness) -> "RelaxedR1CSWitness":
        return RelaxedR1CSWitness(list(witness.W), witness.r_W, [0] * S.num_cons, 0)

    def commit(self, ck: CommitmentKey):
        return (
            CommitmentEngine.commit(ck, self.W, self.r_W),
            CommitmentEngine.commit(ck, self.E, self.r_E),
        )

    def _dev_fold(self, *others) -> bool:
        """The fold runs on the device: for a long witness, or where it or
        one of the vectors folded in (W2's, T) is an FVec already."""
        from nova_tpu_torch.ops.fvec import FVec

        return (
            any(isinstance(v, FVec) for v in (self.W, *others))
            or len(self.W) >= constants.FOLD_DEVICE_THRESHOLD
        )

    def fold(self, field: FieldSpec, W2: R1CSWitness, T: Sequence[int], r_T: int, r: int):
        """W <- W1 + r*W2 ; E <- E1 + r*T (src/r1cs/mod.rs:989-1018)."""
        if len(self.W) != len(W2.W):
            raise InvalidWitnessLengthError()
        p = field.p
        if self._dev_fold(W2.W, T):
            from nova_tpu_torch.fields.tfield import TField
            from nova_tpu_torch.ops.fvec import FVec

            tf = TField(field)
            dev = _vec_device(self.W, self.E, W2.W, T)
            W = FVec.coerce(tf, self.W, dev).axpy(r, FVec.coerce(tf, W2.W, dev))
            E = FVec.coerce(tf, self.E, dev).axpy(r, FVec.coerce(tf, T, dev))
        elif native.available():
            from nova_tpu_torch.ops.fvec import HVec

            W = HVec(p, limbs=native.vec_axpy_l(p, _vec_limbs(self.W, p), _vec_limbs(W2.W, p), r))
            E = HVec(p, limbs=native.vec_axpy_l(p, _vec_limbs(self.E, p), _vec_limbs(T, p), r))
        else:
            from nova_tpu_torch.ops.fvec import as_list

            W1W, W2W = as_list(self.W), as_list(W2.W)
            E1, Tl = as_list(self.E), as_list(T)
            W = [(a + r * b) % p for a, b in zip(W1W, W2W)]
            E = [(a + r * b) % p for a, b in zip(E1, Tl)]
        return RelaxedR1CSWitness(W, (self.r_W + r * W2.r_W) % p, E, (self.r_E + r * r_T) % p)

    def fold_relaxed(self, field: FieldSpec, W2: "RelaxedR1CSWitness", T: Sequence[int], r_T: int, r: int):
        if len(self.W) != len(W2.W):
            raise InvalidWitnessLengthError()
        p = field.p
        r2 = r * r % p
        if self._dev_fold(W2.W, W2.E, T):
            from nova_tpu_torch.fields.tfield import TField
            from nova_tpu_torch.ops.fvec import FVec

            tf = TField(field)
            dev = _vec_device(self.W, self.E, W2.W, W2.E, T)
            W = FVec.coerce(tf, self.W, dev).axpy(r, FVec.coerce(tf, W2.W, dev))
            E = FVec.coerce(tf, self.E, dev).axpy2(
                r, FVec.coerce(tf, T, dev), r2, FVec.coerce(tf, W2.E, dev)
            )
        elif native.available():
            from nova_tpu_torch.ops.fvec import HVec

            W = HVec(p, limbs=native.vec_axpy_l(p, _vec_limbs(self.W, p), _vec_limbs(W2.W, p), r))
            El = native.vec_axpy_l(p, _vec_limbs(self.E, p), _vec_limbs(T, p), r)
            E = HVec(p, limbs=native.vec_axpy_l(p, El, _vec_limbs(W2.E, p), r2))
        else:
            from nova_tpu_torch.ops.fvec import as_list

            W1W, W2W = as_list(self.W), as_list(W2.W)
            E1, Tl, E2 = as_list(self.E), as_list(T), as_list(W2.E)
            W = [(a + r * b) % p for a, b in zip(W1W, W2W)]
            E = [
                (a + r * t + r2 * e2) % p for a, t, e2 in zip(E1, Tl, E2)
            ]
        return RelaxedR1CSWitness(
            W,
            (self.r_W + r * W2.r_W) % p,
            E,
            (self.r_E + r * r_T + r2 * W2.r_E) % p,
        )

    def pad(self, S: R1CSShape) -> "RelaxedR1CSWitness":
        from nova_tpu_torch.ops.fvec import FVec

        if isinstance(self.W, FVec):
            return RelaxedR1CSWitness(
                self.W.pad_to(S.num_vars), self.r_W,
                (self.E.pad_to(S.num_cons)
                 if isinstance(self.E, FVec)
                 else list(self.E) + [0] * (S.num_cons - len(self.E))),
                self.r_E,
            )
        from nova_tpu_torch.ops.fvec import HVec

        if isinstance(self.W, HVec) or isinstance(self.E, HVec):
            import numpy as np

            p = self.W.p if isinstance(self.W, HVec) else self.E.p

            def padv(v, n):
                l = _vec_limbs(v, p)
                if l.shape[0] < n:
                    l = np.vstack([l, np.zeros((n - l.shape[0], 4), dtype=np.uint64)])
                return HVec(p, limbs=l)

            return RelaxedR1CSWitness(
                padv(self.W, S.num_vars), self.r_W, padv(self.E, S.num_cons), self.r_E,
            )
        W = list(self.W) + [0] * (S.num_vars - len(self.W))
        E = list(self.E) + [0] * (S.num_cons - len(self.E))
        return RelaxedR1CSWitness(W, self.r_W, E, self.r_E)

    def derandomize(self):
        return RelaxedR1CSWitness(self.W, 0, self.E, 0), self.r_W, self.r_E


@dataclass
class RelaxedR1CSInstance:
    comm_W: Commitment
    comm_E: Commitment
    X: List[int]
    u: int

    @staticmethod
    def default(curve, S: R1CSShape) -> "RelaxedR1CSInstance":
        return RelaxedR1CSInstance(
            Commitment.default(curve), Commitment.default(curve), [0] * S.num_io, 0
        )

    @staticmethod
    def from_r1cs_instance(curve, S: R1CSShape, instance: R1CSInstance):
        return RelaxedR1CSInstance(
            instance.comm_W, Commitment.default(curve), list(instance.X), 1
        )

    @staticmethod
    def from_r1cs_instance_unchecked(curve, S, comm_W: Commitment, X):
        """src/r1cs/mod.rs: build directly from a commitment and IO (no
        shape checks); used by DirectSNARK."""
        return RelaxedR1CSInstance(comm_W, Commitment.default(curve), list(X), 1)

    def fold(self, field: FieldSpec, U2: R1CSInstance, comm_T: Commitment, r: int):
        """src/r1cs/mod.rs:1182-1208."""
        p = field.p
        X = [(a + r * b) % p for a, b in zip(self.X, U2.X)]
        return RelaxedR1CSInstance(
            self.comm_W + U2.comm_W * r,
            self.comm_E + comm_T * r,
            X,
            (self.u + r) % p,
        )

    def fold_relaxed(self, field: FieldSpec, U2: "RelaxedR1CSInstance", comm_T: Commitment, r: int):
        p = field.p
        r2 = r * r % p
        X = [(a + r * b) % p for a, b in zip(self.X, U2.X)]
        return RelaxedR1CSInstance(
            self.comm_W + U2.comm_W * r,
            self.comm_E + comm_T * r + U2.comm_E * r2,
            X,
            (self.u + r * U2.u) % p,
        )

    def to_transcript_bytes(self, field: FieldSpec) -> bytes:
        out = self.comm_W.to_transcript_bytes()
        out += self.comm_E.to_transcript_bytes()
        out += field.to_repr(self.u)
        for x in self.X:
            out += field.to_repr(x)
        return out

    def absorb_in_ro(self, ro):
        """src/r1cs/mod.rs:1267-1281: comms, u (bit-copy), X as 64-bit limbs."""
        self.comm_W.absorb_in_ro(ro)
        self.comm_E.absorb_in_ro(ro)
        ro.absorb(self.u)
        mask = (1 << BN_LIMB_WIDTH) - 1
        for x in self.X:
            for i in range(BN_N_LIMBS):
                ro.absorb((x >> (BN_LIMB_WIDTH * i)) & mask)

    def derandomize(self, dk: DerandKey, r_W: int, r_E: int):
        return RelaxedR1CSInstance(
            CommitmentEngine.derandomize(dk, self.comm_W, r_W),
            CommitmentEngine.derandomize(dk, self.comm_E, r_E),
            list(self.X),
            self.u,
        )

    def __eq__(self, other):
        return (
            self.comm_W == other.comm_W
            and self.comm_E == other.comm_E
            and self.X == other.X
            and self.u == other.u
        )
