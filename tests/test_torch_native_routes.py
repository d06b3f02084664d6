"""The fold step's native host routes in the port, each taken three ways:
the port with its native binding, the port with ``native.available``
patched False (its pure-Python branches), and the JAX package. Covered:
``FieldSpec.inv``, the Keccak transcript, the Poseidon permutation and the
circuit's permutation witness, the host MSM, ``CommitmentEngine.commit``'s
routes, R1CS satisfiability, the cross-term and the witness folds, the
replay check of ``nova.ivc`` and an FVec's host limbs. Inputs come from
numpy seeds on Pallas/Vesta. Tolerance: exact (field values and limbs
equal, transcript bytes equal, commitments as affine points)."""

import numpy as np
import pytest
import torch

from nova_tpu import native as jn
from nova_tpu.curves.msm_host import msm as jmsm
from nova_tpu.curves.spec import AffinePoint as JA, pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.fields.spec import ALL_FIELDS as JFIELDS
from nova_tpu.gadgets.poseidon_circuit import _permutation_witness as jwitness
from nova_tpu.nova.ivc import _validate_replayed_witness as jvalidate
from nova_tpu.ops.fvec import FVec as JFVec
from nova_tpu.provider import poseidon as jposeidon
from nova_tpu.provider.engines import PallasEngine as JPE
from nova_tpu.provider.keccak import Keccak256Transcript as JTranscript
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
from nova_tpu.r1cs import (
    R1CSInstance as JR1CSInstance,
    R1CSWitness as JR1CSWitness,
    RelaxedR1CSInstance as JRelaxedU,
    RelaxedR1CSWitness as JRelaxedW,
)

from nova_tpu_torch import constants, native as tn
from nova_tpu_torch import r1cs as tr1cs
from nova_tpu_torch.curves import msm_host
from nova_tpu_torch.curves.spec import AffinePoint as TA, pallas as TCURVE
from nova_tpu_torch.errors import TapeReplayError, UnSatError
from nova_tpu_torch.fields.spec import ALL_FIELDS as TFIELDS
from nova_tpu_torch.gadgets.poseidon_circuit import _permutation_witness as twitness
from nova_tpu_torch.nova.ivc import _validate_replayed_witness as tvalidate
from nova_tpu_torch.ops import msm2, msm3
from nova_tpu_torch.ops.fvec import FVec, HVec, as_list
from nova_tpu_torch.provider import poseidon as tposeidon
from nova_tpu_torch.provider.engines import PallasEngine as TPE
from nova_tpu_torch.provider.keccak import Keccak256Transcript as TTranscript
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

from tests.test_nifs import tiny_r1cs
from tests.test_torch_fold import _random_shape, port_key, port_shape

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

P = JPE.scalar.p
ROUTES = ["native", "python"]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's route: its native binding, or (available() patched False)
    its pure-Python branches."""
    assert tn.available() and jn.available()
    if request.param == "python":
        monkeypatch.setattr(tn, "available", lambda: False)
    return request.param


def _rand(rng, n, p=P):
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _counting(monkeypatch, mod, name):
    """Wrap mod.name to count its calls; returns the list of call marks."""
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_field_inverse(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "inv_mod")
    rng = np.random.default_rng(1)
    for name, tf in TFIELDS.items():
        jf = JFIELDS[name]
        vals = _rand(rng, 8, tf.p)
        assert [tf.inv(a) for a in vals] == [jf.inv(a) for a in vals]
        with pytest.raises(ZeroDivisionError):
            tf.inv(0)
    assert bool(calls) == (route == "native")


def test_keccak_transcript(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "keccak_f1600_lanes")
    rng = np.random.default_rng(2)
    msgs = [rng.bytes(40 * (i + 1)) for i in range(5)]  # up to 200 B: several blocks
    out = []
    for t in (TTranscript(b"routes", TPE.scalar), JTranscript(b"routes", JPE.scalar)):
        chal = []
        for m in msgs:
            t.absorb(b"m", m)
            chal.append(t.squeeze(b"c"))
        out.append(chal)
    assert out[0] == out[1]
    assert bool(calls) == (route == "native")


@pytest.mark.parametrize("which", ["wide", "narrow"])
def test_poseidon_permutation(route, monkeypatch, which):
    calls = _counting(monkeypatch, tn, "poseidon_permute")
    tk = getattr(tposeidon.PoseidonROConstants(TPE.scalar), which)
    jk = getattr(jposeidon.PoseidonROConstants(JPE.scalar), which)
    el = _rand(np.random.default_rng(3), tk.width)
    assert tposeidon.permute(tk, el) == jposeidon.permute(jk, el)
    ro_t, ro_j = TPE.new_ro(), JPE.new_ro()
    for x in el:
        ro_t.absorb(x)
        ro_j.absorb(x)
    assert ro_t.squeeze(128) == ro_j.squeeze(128)
    assert bool(calls) == (route == "native")
    if route == "native":
        assert tk._native_ctx is not None  # built once, kept on the constants


@pytest.mark.parametrize("compact", [False, True])
def test_poseidon_permutation_witness(route, monkeypatch, compact):
    calls = _counting(monkeypatch, tn, "poseidon_permute_witness")
    tk = tposeidon.PoseidonROConstants(TPE.scalar).wide
    jk = jposeidon.PoseidonROConstants(JPE.scalar).wide
    el = _rand(np.random.default_rng(4), tk.width)
    state, allocs = twitness(tk, el, compact, P)
    want_state, want_allocs = jwitness(jk, el, compact, P)
    assert list(state) == list(want_state) and list(allocs) == list(want_allocs)
    assert bool(calls) == (route == "native")


def test_host_msm(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "msm")
    rng = np.random.default_rng(5)
    ks = _rand(rng, 20, JCURVE.scalar.p)
    jpts = [JA.generator(JCURVE).mul(k) for k in ks] + [JA.identity(JCURVE)]
    tpts = [TA(TCURVE, q.x, q.y, q.infinity) for q in jpts]
    sc = _rand(rng, len(jpts), JCURVE.scalar.p)
    for n in (5, len(jpts)):  # at most 8 bases: the naive sum in every route
        assert (msm_host.msm(sc[:n], tpts[:n]).to_coordinates()
                == jmsm(sc[:n], jpts[:n]).to_coordinates())
    assert len(calls) == (1 if route == "native" else 0)


@pytest.fixture(scope="module")
def keys():
    """A 64-generator key in both packages; the port's window-shifted
    precomputes (msm3's window 9 on CPU tensors, msm_device2's 12) come
    (512 padded lanes) from the JAX package, as in tests/test_torch_pedersen.py."""
    from nova_tpu.ops import msm3 as jmsm3
    from nova_tpu_torch import interop

    jck = JCE.setup(JCURVE, b"port-native-routes", 48)
    tck = port_key(jck)
    for c in (9, 12):
        fx, fy, finf = jmsm3._fixed3_host(jck.device_bases2(64), c, 512)
        interop.set_fixed(tck.device_bases2(64), c, 512, np.asarray(fx), np.asarray(fy),
                          np.asarray(finf))
    return jck, tck


def test_commit_routes(route, monkeypatch, keys):
    """An FVec takes the fixed-base device MSM on its own device whatever its
    length (the JAX package brings one shorter than FOLD_DEVICE_THRESHOLD to
    the host); an int list of at least DEVICE_THRESHOLD entries
    msm_device2, one of 16 or more the native MSM (with the binding), a
    shorter one the host Pippenger."""
    jck, tck = keys
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 40)
    seen = {name: _counting(monkeypatch, mod, name) for mod, name in (
        (msm3, "msm_device3_mont"), (msm2, "msm_device2"), (tn, "msm_cached"))}
    from nova_tpu_torch.provider import pedersen

    seen["host_msm"] = _counting(monkeypatch, pedersen, "host_msm")
    rng = np.random.default_rng(6)
    native = route == "native"
    cases = [  # (values, as an FVec, the route it must take)
        (_rand(rng, 36), True, "msm_device3_mont"),
        (_rand(rng, 24), True, "msm_device3_mont"),  # below FOLD_DEVICE_THRESHOLD
        (_rand(rng, 44), False, "msm_device2"),
        (_rand(rng, 20), False, "msm_cached" if native else "host_msm"),
        (_rand(rng, 6), False, "host_msm"),  # at most 8 bases: never native
    ]
    for vals, as_fvec, want_route in cases:
        before = {k: len(v) for k, v in seen.items()}
        v = FVec.from_ints(TPE.scalar, vals, device="cpu") if as_fvec else vals
        got = TCE.commit(tck, v, 13)
        taken = [k for k, n in before.items() if len(seen[k]) > n]
        assert taken == [want_route], (len(vals), as_fvec, taken)
        assert got.point.to_coordinates() == JCE.commit(jck, vals, 13).point.to_coordinates()


def _cubic_pair(pkg, S, ck, x, r_W):
    R1CSWitness, R1CSInstance = pkg
    f = JPE.scalar
    z0 = f.mul(x, x)
    z1 = f.mul(z0, x)
    z2 = f.add(z1, x)
    W = R1CSWitness.new(S, [z0, z1, z2, 0], r_W=r_W)
    return R1CSInstance.new(S, W.commit(ck), [x, f.add(z2, 5)]), W


def test_satisfiability(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "vec_sat_check_l")
    jS = tiny_r1cs(JPE)
    jck = jS.commitment_key()
    tS, tck = port_shape(jS), port_key(jck)
    jU, jW = _cubic_pair((JR1CSWitness, JR1CSInstance), jS, jck, 7, 99)
    tU, tW = _cubic_pair((tr1cs.R1CSWitness, tr1cs.R1CSInstance), tS, tck, 7, 99)
    assert tU.comm_W.point.to_coordinates() == jU.comm_W.point.to_coordinates()
    jS.is_sat(jck, jU, jW)
    tS.is_sat(tck, tU, tW)
    rU = tr1cs.RelaxedR1CSInstance.from_r1cs_instance(tck.curve, tS, tU)
    rW = tr1cs.RelaxedR1CSWitness.from_r1cs_witness(tS, tW)
    tS.is_sat_relaxed(tck, rU, rW)
    bad = tr1cs.R1CSWitness(list(tW.W), tW.r_W)
    bad.W[1] = (bad.W[1] + 1) % P
    with pytest.raises(UnSatError, match="unsatisfiable"):
        tS.is_sat(tck, tU, bad)
    with pytest.raises(UnSatError, match="unsatisfiable"):
        tS.is_sat_relaxed(tck, rU, tr1cs.RelaxedR1CSWitness.from_r1cs_witness(tS, bad))
    jbad = JR1CSWitness(list(bad.W), bad.r_W)
    with pytest.raises(Exception, match="unsatisfiable"):
        jS.is_sat(jck, jU, jbad)
    assert len(calls) == (4 if route == "native" else 0)


def test_cross_term_and_witness_folds(route, monkeypatch):
    """commit_T and commit_T_relaxed below the fold threshold (T and its
    commitment), then the witness folds, on a random 64 x 48 shape."""
    calls = _counting(monkeypatch, tn, "vec_cross_l")
    jS = _random_shape(7, nnz=700)
    tS = port_shape(jS)
    jck = JCE.setup(JCURVE, b"port-native-routes", 64)
    tck = port_key(jck)
    rng = np.random.default_rng(8)
    z = _rand(rng, jS.num_vars + jS.num_io + 1)
    assert tS.A.multiply_vec(z) == jS.A.multiply_vec(z)  # 700 entries: native
    W1, E1, W2, E2 = (_rand(rng, n) for n in (48, 64, 48, 64))
    X1, X2 = _rand(rng, 2), _rand(rng, 2)
    u1, u2 = _rand(rng, 2)
    comm = JCE.commit(jck, W1)  # any commitments: T does not read them
    from nova_tpu_torch.provider.pedersen import Commitment

    tcomm = Commitment(TA(TCURVE, *comm.point.to_coordinates()[:2]))
    jU1, jU2 = JRelaxedU(comm, comm, X1, u1), JRelaxedU(comm, comm, X2, u2)
    tU1, tU2 = (tr1cs.RelaxedR1CSInstance(tcomm, tcomm, X, u)
                for X, u in ((X1, u1), (X2, u2)))
    jW1, jW2 = JRelaxedW(W1, 3, E1, 4), JRelaxedW(W2, 5, E2, 6)
    tW1, tW2 = tr1cs.RelaxedR1CSWitness(W1, 3, E1, 4), tr1cs.RelaxedR1CSWitness(W2, 5, E2, 6)
    jwit, twit = JR1CSWitness(W2, 5), tr1cs.R1CSWitness(W2, 5)
    for relaxed in (False, True):
        if relaxed:
            T, cT = tS.commit_T_relaxed(tck, tU1, tW1, tU2, tW2, 11)
            jT, jcT = jS.commit_T_relaxed(jck, jU1, jW1, jU2, jW2, 11)
        else:
            T, cT = tS.commit_T(tck, tU1, tW1, tU2, twit, 11)
            jT, jcT = jS.commit_T(jck, jU1, jW1, jU2, jwit, 11)
        assert isinstance(T, HVec) == (route == "native")
        assert as_list(T) == as_list(jT)
        assert cT.point.to_coordinates() == jcT.point.to_coordinates()
        r = 12345
        if relaxed:
            got, want = tW1.fold_relaxed(TPE.scalar, tW2, T, 9, r), jW1.fold_relaxed(
                JPE.scalar, jW2, jT, 9, r)
        else:
            got, want = tW1.fold(TPE.scalar, twit, T, 9, r), jW1.fold(JPE.scalar, jwit, jT, 9, r)
        assert isinstance(got.W, HVec) == (route == "native")
        assert (as_list(got.W), as_list(got.E)) == (as_list(want.W), as_list(want.E))
        assert (got.r_W, got.r_E) == (want.r_W, want.r_E)
        padded = got.pad(tS.pad())
        assert as_list(padded.W) == as_list(want.pad(jS.pad()).W)
    assert len(calls) == (2 if route == "native" else 0)


def _fold_pair(seed, jck):
    """A random 64 x 48 shape in both packages, and a running and a new
    instance-witness pair with random values (commitments arbitrary: T does
    not read them)."""
    from nova_tpu_torch.provider.pedersen import Commitment

    jS = _random_shape(seed, nnz=700)
    rng = np.random.default_rng(seed + 1)
    W1, E1, W2, E2 = (_rand(rng, n) for n in (48, 64, 48, 64))
    X1, X2 = _rand(rng, 2), _rand(rng, 2)
    u1, u2 = _rand(rng, 2)
    comm = JCE.commit(jck, W1)
    tcomm = Commitment(TA(TCURVE, *comm.point.to_coordinates()[:2]))
    j = (JRelaxedU(comm, comm, X1, u1), JRelaxedW(W1, 3, E1, 4),
         JRelaxedU(comm, comm, X2, u2), JRelaxedW(W2, 5, E2, 6), JR1CSWitness(W2, 5))
    t = (tr1cs.RelaxedR1CSInstance(tcomm, tcomm, X1, u1), tr1cs.RelaxedR1CSWitness(W1, 3, E1, 4),
         tr1cs.RelaxedR1CSInstance(tcomm, tcomm, X2, u2), tr1cs.RelaxedR1CSWitness(W2, 5, E2, 6),
         tr1cs.R1CSWitness(W2, 5))
    return (jS, j), (port_shape(jS), t)


@pytest.mark.parametrize("relaxed", [False, True])
def test_cross_term_at_device_threshold(monkeypatch, keys, relaxed):
    """At or above DEVICE_THRESHOLD (lowered to the shape's 64 rows) the
    cross-term keeps the device SpMV and commits T with msm_device2 (their
    plain versions on these CPU tensors), though the native binding is
    built; T and its commitment equal the JAX package's native route."""
    from nova_tpu_torch.ops import spmv

    jck, tck = keys
    (jS, (jU1, jW1, jU2, jW2, jwit)), (tS, (tU1, tW1, tU2, tW2, twit)) = _fold_pair(17, jck)
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", tS.num_cons)
    seen = {name: _counting(monkeypatch, mod, name) for mod, name in (
        (tn, "vec_cross_l"), (tn, "msm_cached"), (spmv, "multiply_vec_device"),
        (msm2, "msm_device2"))}
    if relaxed:
        T, cT = tS.commit_T_relaxed(tck, tU1, tW1, tU2, tW2, 11)
        jT, jcT = jS.commit_T_relaxed(jck, jU1, jW1, jU2, jW2, 11)
    else:
        T, cT = tS.commit_T(tck, tU1, tW1, tU2, twit, 11)
        jT, jcT = jS.commit_T(jck, jU1, jW1, jU2, jwit, 11)
    assert {k: len(v) for k, v in seen.items()} == {
        "vec_cross_l": 0, "msm_cached": 0, "multiply_vec_device": 1, "msm_device2": 1}
    assert as_list(T) == as_list(jT)
    assert cT.point.to_coordinates() == jcT.point.to_coordinates()


@pytest.mark.parametrize("relaxed", [False, True])
def test_cross_term_at_fold_threshold_on_a_non_square_shape(monkeypatch, keys, relaxed):
    """At or above FOLD_DEVICE_THRESHOLD (both thresholds lowered to the
    64 x 48 shape's rows) the cross-term of a shape that is not square runs
    on the device: one commit_T_device, T an FVec committed by
    msm_device3_mont, no int-list SpMV, msm_device2 or native cross-term;
    T and its commitment equal the JAX package's native route."""
    from nova_tpu_torch.ops import fold, spmv

    jck, tck = keys
    (jS, (jU1, jW1, jU2, jW2, jwit)), (tS, (tU1, tW1, tU2, tW2, twit)) = _fold_pair(19, jck)
    assert tS.num_cons != tS.num_vars
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", tS.num_cons)
    monkeypatch.setattr(constants, "FOLD_DEVICE_THRESHOLD", tS.num_cons)
    seen = {name: _counting(monkeypatch, mod, name) for mod, name in (
        (fold, "commit_T_device"), (msm3, "msm_device3_mont"),
        (spmv, "multiply_vec_device"), (msm2, "msm_device2"), (tn, "vec_cross_l"))}
    if relaxed:
        T, cT = tS.commit_T_relaxed(tck, tU1, tW1, tU2, tW2, 11)
        jT, jcT = jS.commit_T_relaxed(jck, jU1, jW1, jU2, jW2, 11)
    else:
        T, cT = tS.commit_T(tck, tU1, tW1, tU2, twit, 11)
        jT, jcT = jS.commit_T(jck, jU1, jW1, jU2, jwit, 11)
    assert {k: len(v) for k, v in seen.items()} == {
        "commit_T_device": 1, "msm_device3_mont": 1, "multiply_vec_device": 0,
        "msm_device2": 0, "vec_cross_l": 0}
    assert isinstance(T, FVec)
    assert as_list(T) == as_list(jT)
    assert cT.point.to_coordinates() == jcT.point.to_coordinates()


def test_sat_checks_at_device_threshold(monkeypatch, keys):
    """At or above DEVICE_THRESHOLD the satisfiability checks and the replay
    check keep the device SpMV, though the native binding is built; an
    unsatisfied witness still fails each."""
    from nova_tpu_torch.ops import spmv

    tS, tck = port_shape(tiny_r1cs(JPE)), keys[1]
    tU, tW = _cubic_pair((tr1cs.R1CSWitness, tr1cs.R1CSInstance), tS, tck, 5, 21)
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)
    sat = _counting(monkeypatch, tn, "vec_sat_check_l")
    dev = _counting(monkeypatch, spmv, "multiply_vec_device")
    rU = tr1cs.RelaxedR1CSInstance.from_r1cs_instance(tck.curve, tS, tU)
    tS.is_sat(tck, tU, tW)
    tS.is_sat_relaxed(tck, rU, tr1cs.RelaxedR1CSWitness.from_r1cs_witness(tS, tW))
    tvalidate(tS, tU, tW, "primary", "cpu")
    bad = tr1cs.R1CSWitness(list(tW.W), tW.r_W)
    bad.W[0] = (bad.W[0] + 1) % P
    with pytest.raises(UnSatError, match="unsatisfiable"):
        tS.is_sat(tck, tU, bad)
    with pytest.raises(UnSatError, match="unsatisfiable"):
        tS.is_sat_relaxed(tck, rU, tr1cs.RelaxedR1CSWitness.from_r1cs_witness(tS, bad))
    with pytest.raises(TapeReplayError):
        tvalidate(tS, tU, bad, "primary", "cpu")
    assert (len(sat), len(dev)) == (0, 6)


def test_replayed_witness_check(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "vec_sat_check_l")
    jS = tiny_r1cs(JPE)
    jck = jS.commitment_key()
    tS, tck = port_shape(jS), port_key(jck)
    jU, jW = _cubic_pair((JR1CSWitness, JR1CSInstance), jS, jck, 3, 1)
    tU, tW = _cubic_pair((tr1cs.R1CSWitness, tr1cs.R1CSInstance), tS, tck, 3, 1)
    tvalidate(tS, tU, tW, "primary", "cpu")
    jvalidate(jS, jU, jW, "primary")
    tW.W[2] = (tW.W[2] + 1) % P
    jW.W[2] = (jW.W[2] + 1) % P
    with pytest.raises(TapeReplayError):
        tvalidate(tS, tU, tW, "primary", "cpu")
    with pytest.raises(Exception, match="tape discipline"):
        jvalidate(jS, jU, jW, "primary")
    assert len(calls) == (2 if route == "native" else 0)


def test_fvec_host_limbs(route, monkeypatch):
    calls = _counting(monkeypatch, tn, "vec_from_mont_l")
    vals = _rand(np.random.default_rng(9), 33) + [0, 1, P - 1]
    want = JFVec.from_ints(JField(JPE.scalar), vals)
    built = FVec.from_ints(TPE.scalar, vals, device="cpu")
    got = FVec(built.tf, built.m)  # no cached ints
    np.testing.assert_array_equal(got.limbs64(), want.limbs64())
    assert FVec(built.tf, built.m).to_ints() == vals == want.to_ints()
    assert len(calls) == (2 if route == "native" else 0)
