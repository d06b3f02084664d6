"""The port's fold path (``nova_tpu_torch.r1cs``, ``ops.spmv``, ``ops.fold``,
``nova.nifs`` and the int-list route of ``provider.pedersen``) against the
JAX package on CPU, with the device routes forced by lowered thresholds in
both packages (``NOVA_TPU_FORCE_DEVICE=1`` in the JAX package, as
tests/test_fvec.py does), except for the NIFS fold sequence, whose JAX
reference takes its host route.

Shapes and keys are carried across with ``nova_tpu_torch.interop``; inputs
come from numpy seeds. Tolerance: exact throughout (field vectors as ints,
commitments as affine points)."""

import numpy as np
import pytest
import torch

from nova_tpu.curves.spec import pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.nova.nifs import NIFS as JNIFS
from nova_tpu.ops import msm3 as jmsm3
from nova_tpu.ops.fold import commit_T_device as jcommit_T_device
from nova_tpu.ops.fold import fold_witness_device as jfold_witness_device
from nova_tpu.ops.spmv import multiply_vec_device as jmultiply_vec_device
from nova_tpu.provider.engines import PallasEngine as JPE
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
from nova_tpu.r1cs import (
    R1CSInstance as JR1CSInstance,
    R1CSShape as JR1CSShape,
    R1CSWitness as JR1CSWitness,
    RelaxedR1CSInstance as JRelaxedU,
    RelaxedR1CSWitness as JRelaxedW,
    SparseMatrix as JSparseMatrix,
)

from nova_tpu_torch import constants, interop
from nova_tpu_torch import r1cs as tr1cs
from nova_tpu_torch.curves.spec import AffinePoint, pallas as TCURVE
from nova_tpu_torch.nova.nifs import NIFS as TNIFS
from nova_tpu_torch.ops import msm2
from nova_tpu_torch.ops.fold import commit_T_device, fold_witness_device
from nova_tpu_torch.ops.fvec import FVec, as_list
from nova_tpu_torch.ops.spmv import get_device_csr, multiply_vec_device
from nova_tpu_torch.provider.engines import PallasEngine as TPE
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

from tests.test_nifs import tiny_r1cs
from tests.test_torch_profiling import tracing  # noqa: F401  (a fixture)

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

P = JPE.scalar.p


def shape_arrays(S) -> dict:
    """A JAX-package R1CSShape as interop.r1cs_shape's arguments."""
    jf = JField(S.field)
    out = {"num_cons": S.num_cons, "num_vars": S.num_vars, "num_io": S.num_io}
    for name in ("A", "B", "C"):
        M = getattr(S, name)
        data = np.asarray(jf.pack(M.data)) if M.data else np.zeros((0, 16), np.uint32)
        out[name] = (data, np.asarray(M.indices), np.asarray(M.indptr))
    return out


def key_rows(ck) -> np.ndarray:
    """A JAX-package CommitmentKey as (N + 1, 65) uint8 rows, h first."""
    gens = [ck.h] + list(ck.ck)
    rows = np.zeros((len(gens), 65), dtype=np.uint8)
    for i, g in enumerate(gens):
        if g.infinity:
            rows[i, 64] = 1
            continue
        rows[i, :32] = np.frombuffer(g.x.to_bytes(32, "little"), np.uint8)
        rows[i, 32:64] = np.frombuffer(g.y.to_bytes(32, "little"), np.uint8)
    return rows


def port_shape(S):
    return interop.r1cs_shape(
        TPE.scalar, S.num_cons, S.num_vars, S.num_io, shape_arrays(S)
    )


def port_key(jck, curve=TCURVE):
    return interop.commitment_key(curve, key_rows(jck), "cpu")


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _pt(c):
    return c.point.to_coordinates()


def _inst(U):
    return (_pt(U.comm_W), _pt(U.comm_E), list(U.X), U.u)


def _random_shape(seed, rows=64, cols=48, nnz=300, num_io=2):
    rng = np.random.default_rng(seed)
    trip = {}
    for _ in range(nnz):
        trip[(int(rng.integers(rows)), int(rng.integers(cols + num_io + 1)))] = (
            int.from_bytes(rng.bytes(32), "little") % P
        )
    trip[(rows - 1, 0)] = P - 1
    mats = [
        JSparseMatrix.new(JPE.scalar, [(r, c, v) for (r, c), v in trip.items()],
                          rows, cols + num_io + 1)
        for _ in range(3)
    ]
    mats[1] = JSparseMatrix.new(JPE.scalar, [(r, c, 1) for (r, c) in trip], rows,
                                cols + num_io + 1)
    return JR1CSShape.new(JPE.scalar, rows, cols, num_io, *mats)


def test_spmv_matches_reference(monkeypatch):
    monkeypatch.setenv("NOVA_TPU_FORCE_DEVICE", "1")
    jS = _random_shape(1)
    tS = port_shape(jS)
    z = _rand(np.random.default_rng(2), jS.num_vars + jS.num_io + 1)
    want = jmultiply_vec_device(jS, z)
    got = multiply_vec_device(tS, z, "cpu")
    assert [list(v) for v in got] == [list(v) for v in want]
    assert [list(v) for v in got] == [list(v) for v in tS.multiply_vec(z)]
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)
    calls = []
    real = multiply_vec_device
    import nova_tpu_torch.ops.spmv as spmv

    monkeypatch.setattr(spmv, "multiply_vec_device",
                        lambda *a: calls.append(a[2]) or real(*a))
    assert tS.multiply_vec(z, "cpu") == got and calls == ["cpu"]


@pytest.mark.parametrize("relaxed", [False, True])
def test_commit_T_device_matches_reference(monkeypatch, relaxed):
    monkeypatch.setenv("NOVA_TPU_FORCE_DEVICE", "1")
    jS = tiny_r1cs(JPE)
    tS = port_shape(jS)
    rng = np.random.default_rng(3 + relaxed)
    nv, nc = jS.num_vars, jS.num_cons
    W1 = JRelaxedW(_rand(rng, nv), 0, _rand(rng, nc), 0)
    W2 = JRelaxedW(_rand(rng, nv), 0, _rand(rng, nc) if relaxed else [0] * nc, 0)
    U1 = JRelaxedU(None, None, _rand(rng, 2), _rand(rng, 1)[0])
    U2 = JRelaxedU(None, None, _rand(rng, 2), _rand(rng, 1)[0] if relaxed else 1)
    want = jcommit_T_device(jS, U1, W1, U2, W2, relaxed=relaxed)
    tW1 = tr1cs.RelaxedR1CSWitness(W1.W, 0, W1.E, 0)
    tW2 = tr1cs.RelaxedR1CSWitness(W2.W, 0, W2.E, 0)
    got = commit_T_device(tS, U1, tW1, U2, tW2, relaxed, "cpu")
    assert isinstance(got, FVec) and got.device.type == "cpu"
    assert got.to_ints() == want.to_ints()


def test_fold_witness_device_matches_reference():
    rng = np.random.default_rng(6)
    vecs = [_rand(rng, 40) for _ in range(4)]
    r = _rand(rng, 1)[0]
    want = jfold_witness_device(JPE.scalar, *vecs, r)
    assert fold_witness_device(TPE.scalar, *vecs, r, device="cpu") == tuple(want)


def _fold_sequence(pkg, S, ck):
    """Three NIFS folds of the tiny cubic instance (tests/test_fvec.py's
    sequence); returns the running instance and the witness vectors."""
    NIFS, R1CSWitness, R1CSInstance, RU, RW = pkg
    f = JPE.scalar
    U_r = RU.default(ck.curve, S)
    W_r = RW.default(S)
    for i, x in enumerate((5, 135, 7)):
        z0 = f.mul(x, x)
        z1 = f.mul(z0, x)
        z2 = f.add(z1, x)
        W2 = R1CSWitness.new(S, [z0, z1, z2, 0], r_W=1000 + i)
        U2 = R1CSInstance.new(S, W2.commit(ck), [x, f.add(z2, 5)])
        _, (U_r, W_r) = NIFS.prove(ck, JPE if NIFS is JNIFS else TPE, 0x1234, S,
                                   U_r, W_r, U2, W2, r_T=77 + i)
    S.is_sat_relaxed(ck, U_r, W_r)
    return U_r, W_r


def test_nifs_fold_sequence_matches_reference(monkeypatch):
    """The port's folds on its device routes (FVec folds, fixed-base
    commits) against the JAX package's folds on its host route: the same
    values (the JAX package holds its device routes to its host route in
    tests/test_fvec.py), without compiling its XLA device programs."""
    monkeypatch.setattr(constants, "FOLD_DEVICE_THRESHOLD", 1)
    jS = tiny_r1cs(JPE)
    jck = jS.commitment_key()
    tS, tck = port_shape(jS), port_key(jck)
    # the reference's window-9 precompute for the port's CPU MSM
    fx, fy, finf = jmsm3._fixed3_host(jck.device_bases2(4), 9, 512)
    interop.set_fixed(tck.device_bases2(4), 9, 512, np.asarray(fx), np.asarray(fy),
                      np.asarray(finf))
    jU, jW = _fold_sequence(
        (JNIFS, JR1CSWitness, JR1CSInstance, JRelaxedU, JRelaxedW), jS, jck)
    tU, tW = _fold_sequence(
        (TNIFS, tr1cs.R1CSWitness, tr1cs.R1CSInstance, tr1cs.RelaxedR1CSInstance,
         tr1cs.RelaxedR1CSWitness), tS, tck)
    assert isinstance(tW.W, FVec) and tW.W.device.type == "cpu"
    assert _inst(tU) == _inst(jU)
    assert as_list(tW.W) == list(jW.W) and as_list(tW.E) == list(jW.E)
    assert (tW.r_W, tW.r_E) == (jW.r_W, jW.r_E)
    # a tampered witness fails the port's relaxed check
    bad = tr1cs.RelaxedR1CSWitness(as_list(tW.W), tW.r_W, as_list(tW.E), tW.r_E)
    bad.E[0] = (bad.E[0] + 1) % P
    with pytest.raises(Exception, match="unsatisfiable"):
        tS.is_sat_relaxed(tck, tU, bad)


def test_nifs_folds_a_non_square_shape_on_the_device(monkeypatch, tracing):
    """Three NIFS folds of random pairs into a running W and E held as
    FVecs, on a 16 x 12 shape (not square) with both thresholds lowered to
    its rows: each fold converts W2 and the short (u, X) tail towards the
    device once and nothing back, counts its rows as the cross-term's device
    rows, and gives the JAX package's comm_T, folded instance and folded W
    and E (its native host route)."""
    from nova_tpu_torch.provider.pedersen import Commitment

    jS = _random_shape(23, rows=16, cols=12, nnz=120)
    tS = port_shape(jS)
    nv, nc, nio = tS.num_vars, tS.num_cons, tS.num_io
    assert nc != nv
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", nc)
    monkeypatch.setattr(constants, "FOLD_DEVICE_THRESHOLD", nc)
    jck = JCE.setup(JCURVE, b"port-fold-non-square", nc)
    tck = port_key(jck)
    # the reference's window-9 precompute for the port's CPU MSM of T
    fx, fy, finf = jmsm3._fixed3_host(jck.device_bases2(nc), 9, 512)
    interop.set_fixed(tck.device_bases2(nc), 9, 512, np.asarray(fx), np.asarray(fy),
                      np.asarray(finf))
    rng = np.random.default_rng(24)
    comm = JCE.commit(jck, _rand(rng, 4))  # any commitment: T does not read it
    tcomm = Commitment(AffinePoint(TCURVE, *_pt(comm)[:2]))
    W1, E1, X1, (u1,) = _rand(rng, nv), _rand(rng, nc), _rand(rng, nio), _rand(rng, 1)
    jU, jW = JRelaxedU(comm, comm, X1, u1), JRelaxedW(W1, 3, E1, 4)
    tU = tr1cs.RelaxedR1CSInstance(tcomm, tcomm, X1, u1)
    tW = tr1cs.RelaxedR1CSWitness(FVec.from_ints(TPE.scalar, W1, "cpu"), 3,
                                  FVec.from_ints(TPE.scalar, E1, "cpu"), 4)
    for which in "ABC":  # the matrices cross once a shape, before the folds
        get_device_csr(tS, which, tW.W.device)
    for i in range(3):
        W2, X2 = _rand(rng, nv), _rand(rng, nio)
        tracing.global_reset()
        tn, (tU, tW) = TNIFS.prove(tck, TPE, 0x1234, tS, tU, tW,
                                   tr1cs.R1CSInstance(tcomm, X2), tr1cs.R1CSWitness(W2, 5 + i),
                                   r_T=77 + i)
        c = tracing.counters()
        jn, (jU, jW) = JNIFS.prove(jck, JPE, 0x1234, jS, jU, jW, JR1CSInstance(comm, X2),
                                   JR1CSWitness(W2, 5 + i), r_T=77 + i)
        assert (c["conv.to_device"], c.get("conv.to_host", 0)) == (nv + 1 + nio, 0)
        assert c["nifs.cross_term_rows.device"] == nc
        assert "nifs.cross_term_rows.host" not in c
        assert isinstance(tW.W, FVec) and isinstance(tW.E, FVec)
        assert _pt(tn.comm_T) == _pt(jn.comm_T)
        assert _inst(tU) == _inst(jU)
        assert (as_list(tW.W), as_list(tW.E)) == (list(jW.W), list(jW.E))
        assert (tW.r_W, tW.r_E) == (jW.r_W, jW.r_E)


def test_commit_int_list_takes_msm_device2(monkeypatch):
    """A plain int list of at least DEVICE_THRESHOLD entries goes to
    msm_device2 on the key's device (fixed-base, reused key)."""
    n = 300
    jck = JCE.setup(JCURVE, b"port-fold-commit", n)
    tck = port_key(jck)
    fx, fy, finf = jmsm3._fixed3_host(jck.device_bases2(n), 12, 512)
    interop.set_fixed(tck.device_bases2(n), 12, 512, np.asarray(fx), np.asarray(fy),
                      np.asarray(finf))
    vals = _rand(np.random.default_rng(8), n)
    want = JCE.commit(jck, vals, 11)
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", n)
    seen = []
    real = msm2.msm_device2
    monkeypatch.setattr(msm2, "msm_device2",
                        lambda v, **k: seen.append((len(v), k["reuse"])) or real(v, **k))
    got = TCE.commit(tck, vals, 11)
    assert seen == [(n, True)]
    assert _pt(got) == _pt(want)
    assert _pt(TCE.commit(tck, vals[:-1], 11)) == _pt(JCE.commit(jck, vals[:-1], 11))
    assert len(seen) == 1  # one entry short of the threshold: host Pippenger


def test_device_routes_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    jS = tiny_r1cs(JPE)
    with pytest.raises(RuntimeError, match="CUDA"):
        multiply_vec_device(port_shape(jS), [1] * 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        msm2.msm_device2([1, 2], bases=[AffinePoint.generator(TCURVE)] * 2)
