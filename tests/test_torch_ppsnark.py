"""The port's preprocessing Spartan (``nova_tpu_torch.spartan.ppsnark``),
DirectSNARK (``spartan.direct``) and the Spartan pieces they add
(MaskedEq/Pow/Identity polynomials, gaussian_elimination,
UniPoly.from_evals, PolyEvalWitness/Instance.batch,
SumcheckProof.prove_batched_cubic) against the JAX package on CPU,
mirroring tests/test_spartan.py.

Shapes and keys are carried across with ``interop``; inputs come from
seeded generators. Each ppsnark proof is taken three ways on the port's
side: with the native binding (the host route), with DEVICE_THRESHOLD
lowered while proving (the device outer sumcheck on CPU tensors, its plain
version), and with ``native.available`` patched False. DirectSNARK draws its blinds from ``secrets.randbelow``, patched to
one seeded generator restarted for each package. Tolerance: exact (every
proof field equal; commitments as affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.frontend.constraint_system import ONE as JONE, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import StepCircuit as JStep
from nova_tpu.provider.engines import Bn256EngineIPA as JBN, PallasEngine as JPE
from nova_tpu.provider.hyperkzg import EvaluationEngine as JKZG, setup_insecure
import nova_tpu.r1cs as jr1cs
from nova_tpu.spartan import PolyEvalInstance as JPEI, PolyEvalWitness as JPEW
from nova_tpu.spartan.direct import DirectSNARK as JDirect
from nova_tpu.spartan.polys import (
    EqPolynomial as JEq,
    IdentityPolynomial as JIdent,
    MaskedEqPolynomial as JMasked,
    MultilinearPolynomial as JML,
    PowPolynomial as JPow,
    UniPoly as JUni,
    gaussian_elimination as jgauss,
)
from nova_tpu.spartan.ppsnark import (
    R1CSShapeSparkRepr as JRepr,
    RelaxedR1CSSNARK as JPP,
)
from nova_tpu.spartan.snark import RelaxedR1CSSNARK as JSNARK
from nova_tpu.spartan.sumcheck import SumcheckProof as JSC

from nova_tpu_torch import constants, interop, native as tnative
from nova_tpu_torch import r1cs as tr1cs
from nova_tpu_torch.curves.spec import AffinePoint, bn254 as TBN254, pallas as TPALLAS
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.ops import sumcheck as tops_sumcheck
from nova_tpu_torch.provider.engines import Bn256EngineIPA as TBN, PallasEngine as TPE
from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as TKZG
from nova_tpu_torch.provider.ipa import InnerProductArgument
from nova_tpu_torch.provider.pedersen import Commitment
from nova_tpu_torch.spartan import PolyEvalInstance as TPEI, PolyEvalWitness as TPEW
from nova_tpu_torch.spartan.direct import DirectSNARK as TDirect
from nova_tpu_torch.spartan.polys import (
    CompressedUniPoly,
    EqPolynomial as TEq,
    IdentityPolynomial as TIdent,
    MaskedEqPolynomial as TMasked,
    MultilinearPolynomial as TML,
    PowPolynomial as TPow,
    UniPoly as TUni,
    gaussian_elimination as tgauss,
)
from nova_tpu_torch.spartan.ppsnark import (
    R1CSShapeSparkRepr as TRepr,
    RelaxedR1CSSNARK as TPP,
)
from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK as TSNARK
from nova_tpu_torch.spartan.sumcheck import SumcheckProof as TSC

from tests.test_nifs import tiny_r1cs
from tests.test_torch_fold import key_rows, port_key, shape_arrays
from tests.test_torch_ivc import cubic
from tests.test_torch_spartan import _derandomized_pair, _polys, _pt, snark_fields

torch.set_num_threads(1)

F = JPE.scalar
P = F.p


def _rand(rng, n, p=P):
    return [rng.randrange(p) for _ in range(n)]


def test_new_polys_match_reference():
    rng = random.Random(3)
    r = _rand(rng, 5)
    x = _rand(rng, 5)
    tm, jm = TMasked(TEq(F, r), 3), JMasked(JEq(F, r), 3)
    assert tm.evals() == jm.evals()
    assert all(v == 0 for v in tm.evals()[:8])
    assert tm.evaluate(x) == jm.evaluate(x)
    assert TIdent(F, 5).evaluate(x) == JIdent(F, 5).evaluate(x)
    t = rng.randrange(P)
    tp, jp = TPow(F, t, 4), JPow(F, t, 4)
    assert tp.coordinates() == jp.coordinates()
    assert tp.evals() == jp.evals()
    assert tp.evaluate(x[:4]) == jp.evaluate(x[:4])
    assert tp.split_evals(4, 4) == jp.split_evals(4, 4)
    m = [_rand(rng, 5) for _ in range(4)]
    assert tgauss(F, [list(row) for row in m]) == jgauss(F, [list(row) for row in m])
    for n in (1, 3, 5):
        ev = _rand(rng, n)
        up = TUni.from_evals(F, ev)
        assert up.coeffs == JUni.from_evals(F, ev).coeffs
        assert [up.evaluate(i) for i in range(n)] == [e % P for e in ev]


@pytest.mark.parametrize("route", ["native", "python"])
def test_batch_methods_match_reference(route, monkeypatch):
    rng = random.Random(4)
    polys = [_rand(rng, 64) for _ in range(3)]
    s = rng.randrange(P)
    jw = JPEW.batch(F, [list(q) for q in polys], s)
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    tw = TPEW.batch(F, [list(q) for q in polys], s)
    assert list(tw.p) == list(jw.p)
    g = AffinePoint.generator(TPALLAS)
    tcs = [Commitment(g.mul(rng.randrange(P))) for _ in range(3)]
    from nova_tpu.curves.spec import AffinePoint as JAffine, pallas as JPALLAS
    from nova_tpu.provider.pedersen import Commitment as JCommitment

    jcs = [JCommitment(JAffine(JPALLAS, c.point.x, c.point.y, c.point.infinity))
           for c in tcs]
    x, e = _rand(rng, 6), _rand(rng, 3)
    ti, ji = TPEI.batch(F, tcs, x, e, s), JPEI.batch(F, jcs, x, e, s)
    assert (_pt(ti.c), ti.x, ti.e) == (_pt(ji.c), ji.x, ji.e)


def test_prove_batched_cubic_matches_reference():
    rng = random.Random(5)
    n, k = 16, 3
    tabs = [[_rand(rng, n) for _ in range(3)] for _ in range(k)]
    taus, alphas = _rand(rng, 4), _rand(rng, k)
    eq = JEq.evals_from_points(F, taus)
    claim = sum(al * e * (a * b - c) for al, (A, B, C) in zip(alphas, tabs)
                for e, a, b, c in zip(eq, A, B, C)) % P
    out = []
    for SC, ML, tr in ((JSC, JML, JPE.new_transcript(b"bc")),
                       (TSC, TML, TPE.new_transcript(b"bc"))):
        polys = [[ML(F, list(t)) for t in group] for group in zip(*tabs)]
        proof, r, claims = SC.prove_batched_cubic(F, claim, taus, *polys, alphas, tr)
        out.append((_polys(proof), r, claims))
    assert out[0] == out[1]
    tr = TPE.new_transcript(b"bc")
    e, r = TSC(
        [CompressedUniPoly(F, cs) for cs in out[1][0]]).verify(F, claim, 4, 3, tr)
    assert r == out[1][1]


def _shapes(je, te, num_vars):
    """tests/test_nifs.py's cubic R1CS in the JAX package (engine `je`), and
    the port's copy of it through interop (engine `te`)."""
    jS = tiny_r1cs(je, num_vars=num_vars)
    tS = interop.r1cs_shape(te.scalar, jS.num_cons, jS.num_vars, jS.num_io, shape_arrays(jS))
    return jS, tS


@pytest.mark.parametrize("num_vars", [4, 16, 32])
def test_spark_repr_matches_reference(num_vars):
    jS, tS = _shapes(JPE, TPE, num_vars)
    jS, tS = jS.pad(), tS.pad()
    jr, tr = JRepr(jS), TRepr(tS)
    assert tr.N == jr.N
    assert tr.vectors() == [jr.row, jr.col, jr.val_A, jr.val_B, jr.val_C, jr.ts_row,
                            jr.ts_col]
    jck = jS.commitment_key(b"ck", 2 * jr.N)
    tck = port_key(jck)
    assert [_pt(c) for c in tr.commit(tck).comms()] == [
        _pt(c) for c in (lambda s: [s.comm_row, s.comm_col, s.comm_val_A, s.comm_val_B,
                                    s.comm_val_C, s.comm_ts_row, s.comm_ts_col])(
            jr.commit(jck))]


def pp_fields(s, kzg=False):
    """Every field of a ppsnark proof, as plain ints and coordinates."""
    out = {}
    for k, v in vars(s).items():
        if k == "eval_arg":
            if kzg:
                out[k] = ([_pt(c) for c in v.com], [_pt(c) for c in v.w],
                          [list(row) for row in v.v])
            else:
                out[k] = ([_pt(L) for L in v.L_vec], [_pt(R) for R in v.R_vec], v.a_hat)
        elif hasattr(v, "point"):
            out[k] = _pt(v)
        elif hasattr(v, "compressed_polys"):
            out[k] = _polys(v)
        else:
            out[k] = v
    return out


CONFIGS = {
    # (JAX engine, port engine, port curve, JAX EE, port EE)
    "pallas-ipa": (JPE, TPE, TPALLAS, None, None),
    "bn254-ipa": (JBN, TBN, TBN254, None, None),
    "bn254-hyperkzg": (JBN, TBN, TBN254, JKZG, TKZG),
}


def _keys(cfg, jS):
    je, te, tcurve, jee, tee = CONFIGS[cfg]
    floor = max(JPP.ck_floor(jS), 2 * jS.num_vars, 64)
    if jee is None:
        jck = jS.commitment_key(b"ck", floor)
        return jck, port_key(jck, tcurve)
    jck, tau_H = setup_insecure(floor)
    return jck, interop.kzg_commitment_key(key_rows(jck), (tau_H.x, tau_H.y), "cpu")


@pytest.mark.parametrize("route", ["host", "device", "python"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_ppsnark_matches_reference(cfg, route, monkeypatch):
    """ppsnark on the cubic R1CS padded to 16 variables (N = 32): the setup
    digest, every proof field, the port's verify, and tampered evaluations
    failing. The device route lowers DEVICE_THRESHOLD while proving, as
    tests/test_torch_spartan.py::test_snark_matches_reference does (the
    setup's spark commits through msm_device2 are held on the card)."""
    je, te, tcurve, jee, tee = CONFIGS[cfg]
    jS, tS = _shapes(je, te, 16)
    jck, tck = _keys(cfg, jS)
    jU, jW = _derandomized_pair(jr1cs, jS, jck, 3, 1001)
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 3, 1001)
    jpk, jvk = JPP.setup(je, jck, jS, ee=jee)
    jproof = JPP.prove(je, jck, jpk, jS, jU, jW)
    calls = []
    with monkeypatch.context() as m:
        if route == "python":
            m.setattr(tnative, "available", lambda: False)
        tpk, tvk = TPP.setup(te, tck, tS, ee=tee)
        assert tpk.vk_digest == jpk.vk_digest == tvk.digest()
        if route == "device":
            m.setattr(constants, "DEVICE_THRESHOLD", 1)
            real = tops_sumcheck.prove_cubic_with_three_inputs_device
            m.setattr(tops_sumcheck, "prove_cubic_with_three_inputs_device",
                      lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
        tproof = TPP.prove(te, tck, tpk, tS, tU, tW)
    assert calls == ([tck.device] if route == "device" else [])
    assert pp_fields(tproof, jee is not None) == pp_fields(jproof, jee is not None)
    tproof.verify(tvk, tU)
    for name in ("eval_L_row", "eval_W", "eval_ts_col"):
        good = getattr(tproof, name)
        setattr(tproof, name, (good + 1) % te.scalar.p)
        with pytest.raises(NovaError):
            tproof.verify(tvk, tU)
        setattr(tproof, name, good)


def _port_proof(jproof, curve):
    """A JAX-package IPA ppsnark proof as the port's RelaxedR1CSSNARK."""
    kw = {}
    for k, v in vars(jproof).items():
        if k == "eval_arg":
            kw[k] = InnerProductArgument(
                [Commitment(AffinePoint(curve, *c.point.to_coordinates())) for c in v.L_vec],
                [Commitment(AffinePoint(curve, *c.point.to_coordinates())) for c in v.R_vec],
                v.a_hat)
        elif hasattr(v, "point"):
            kw[k] = Commitment(AffinePoint(curve, *v.point.to_coordinates()))
        elif hasattr(v, "compressed_polys"):
            kw[k] = TSC([CompressedUniPoly(curve.scalar, cs) for cs in _polys(v)])
        else:
            kw[k] = v
    return TPP(**kw)


def test_ppsnark_keys_cross_verify():
    """interop.ppsnark_keys: the port's proof verifies under the JAX vk
    carried across, and the JAX package's proof verifies in the port under
    that vk; the port proves with the carried pk the JAX package's proof."""
    jS, tS = _shapes(JPE, TPE, 16)
    jck, tck = _keys("pallas-ipa", jS)
    jU, jW = _derandomized_pair(jr1cs, jS, jck, 5, 77)
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 5, 77)
    jpk, jvk = JPP.setup(JPE, jck, jS)
    cpk, cvk = interop.ppsnark_keys(jpk, jvk, "cpu")
    assert cvk.digest() == jvk.digest() == cpk.vk_digest
    tpk, _ = TPP.setup(TPE, tck, tS)
    TPP.prove(TPE, tck, tpk, tS, tU, tW).verify(cvk, tU)
    jproof = JPP.prove(JPE, jck, jpk, jS, jU, jW)
    _port_proof(jproof, TPALLAS).verify(cvk, tU)
    assert pp_fields(TPP.prove(TPE, tck, cpk, tS, tU, tW)) == pp_fields(jproof)
    # and HyperKZG's verifier key (points of G1 and G2)
    jS, tS = _shapes(JBN, TBN, 16)
    jck, tck = _keys("bn254-hyperkzg", jS)
    jpk, jvk = JPP.setup(JBN, jck, jS, ee=JKZG)
    cpk, cvk = interop.ppsnark_keys(jpk, jvk, "cpu")
    assert cvk.digest() == jvk.digest() and cvk.ee is TKZG
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 5, 77)
    TPP.prove(TBN, tck, cpk, tS, tU, tW).verify(cvk, tU)


def _direct(Direct, SNARK, engine, circuit, seed, monkeypatch, **setup_kw):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    pk, vk = Direct.setup(engine, circuit, S_snark=SNARK, **setup_kw)
    return Direct.prove(engine, pk, circuit, [2], S_snark=SNARK), vk


@pytest.mark.parametrize("kind", ["snark", "ppsnark"])
def test_direct_snark_matches_reference(kind, monkeypatch):
    """DirectSNARK on tests/test_ivc.py's cubic circuit (z = 2 -> 15): equal
    proofs, the port's verify, and a changed io failing."""
    jsn, tsn, fields = {"snark": (JSNARK, TSNARK, snark_fields),
                        "ppsnark": (JPP, TPP, pp_fields)}[kind]
    j, jvk = _direct(JDirect, jsn, JPE, cubic(JStep, JNum, JONE, jlc), 31, monkeypatch)
    t, tvk = _direct(TDirect, tsn, TPE, cubic(TStep, TNum, TONE, tlc), 31, monkeypatch,
                     device="cpu")
    assert (_pt(t.comm_W), t.blind_r_W) == (_pt(j.comm_W), j.blind_r_W)
    assert fields(t.snark) == fields(j.snark)
    io = [2, (2 ** 3 + 2 + 5) % P]
    t.verify(TPE, tvk, io)
    with pytest.raises(NovaError):
        t.verify(TPE, tvk, [2, io[1] + 1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TDirect.setup(TPE, cubic(TStep, TNum, TONE, tlc), S_snark=tsn)
