"""The port's Spartan layer (``nova_tpu_torch.spartan``: polynomials,
sumcheck, batch evaluation, RelaxedR1CSSNARK), its IPA evaluation engine
(``provider.ipa``) and its device outer sumcheck (``ops.sumcheck``) against
the JAX package on CPU, mirroring tests/test_spartan.py.

Inputs come from seeded generators and keys are carried across with
``interop`` (tests/test_torch_fold.py's helpers), so both packages prove the
same statements; every comparison is exact: round polynomials, challenges,
claims, evaluations and commitments (as affine points) are equal. Table
sizes below and above the native loops' threshold (32) run the pure-Python
and the native round loops."""

import copy
import random

import pytest
import torch

from nova_tpu.ops.sumcheck import prove_cubic_with_three_inputs_device as jdevice_cubic
from nova_tpu.provider.engines import PallasEngine as JPE, VestaEngine as JVE
from nova_tpu.provider.ipa import EvaluationEngine as JIPA
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
import nova_tpu.r1cs as jr1cs
from nova_tpu.spartan import (
    PolyEvalInstance as JPEI,
    PolyEvalWitness as JPEW,
    batch_eval_reduce as jreduce,
    batch_invert as jbatch_invert,
)
from nova_tpu.spartan.polys import (
    EqPolynomial as JEq,
    MultilinearPolynomial as JML,
    SparsePolynomial as JSparse,
)
from nova_tpu.spartan.snark import RelaxedR1CSSNARK as JSNARK
from nova_tpu.spartan.sumcheck import SumcheckProof as JSC

from nova_tpu_torch import constants, native as tnative
from nova_tpu_torch import r1cs as tr1cs
from nova_tpu_torch.curves.spec import pallas as TPALLAS, vesta as TVESTA
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import sumcheck as tops_sumcheck
from nova_tpu_torch.provider.engines import PallasEngine as TPE, VestaEngine as TVE
from nova_tpu_torch.provider.ipa import EvaluationEngine as TIPA
from nova_tpu_torch.provider.pedersen import Commitment as TCommitment
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE
from nova_tpu_torch.spartan import (
    PolyEvalInstance as TPEI,
    PolyEvalWitness as TPEW,
    batch_eval_reduce as treduce,
    batch_eval_verify as tverify,
    batch_invert as tbatch_invert,
)
from nova_tpu_torch.spartan.polys import (
    EqPolynomial as TEq,
    MultilinearPolynomial as TML,
    SparsePolynomial as TSparse,
    UniPoly as TUni,
)
from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK as TSNARK
from nova_tpu_torch.spartan.sumcheck import SumcheckProof as TSC

from tests.test_nifs import tiny_r1cs
from tests.test_torch_fold import port_key, port_shape

torch.set_num_threads(1)

F = JPE.scalar
P = F.p


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


def _polys(proof):
    return [cp.coeffs_except_linear_term for cp in proof.compressed_polys]


def _pt(c):
    return c.point.to_coordinates()


def _tcomm(jc, curve=TPALLAS):
    """A JAX-package commitment as the port's."""
    from nova_tpu_torch.curves.spec import AffinePoint

    x, y, inf = jc.point.to_coordinates()
    return TCommitment(AffinePoint(curve, x, y, inf))


def test_polys_match_reference():
    rng = random.Random(1)
    r = _rand(rng, 9)
    assert TEq.evals_from_points(F, r) == JEq.evals_from_points(F, r)  # native
    assert TEq.evals_from_points(F, r[:4]) == JEq.evals_from_points(F, r[:4])
    assert TEq.evals_hvec(F, r).to_ints() == JEq.evals_hvec(F, r).to_ints()
    assert TEq(F, r[:4]).evaluate(r[4:8]) == JEq(F, r[:4]).evaluate(r[4:8])
    Z = _rand(rng, 16)
    assert TML.evaluate_with(F, Z, r[:4]) == JML.evaluate_with(F, Z, r[:4])
    tp, jp = TML(F, Z), JML(F, Z)
    for x in r[:4]:
        tp.bind_poly_var_top(x)
        jp.bind_poly_var_top(x)
    assert tp.Z == jp.Z
    assert TSparse(F, 4, Z[:3]).evaluate(r[:4]) == JSparse(F, 4, Z[:3]).evaluate(r[:4])
    uni = TUni(F, _rand(rng, 4))
    hint = (uni.eval_at_zero() + uni.eval_at_one()) % P
    assert uni.compress().decompress(hint).coeffs == uni.coeffs
    v = _rand(rng, 70)
    assert tbatch_invert(F, v) == jbatch_invert(F, v)  # native
    assert tbatch_invert(F, v[:33]) == jbatch_invert(F, v[:33])


@pytest.mark.parametrize("n", [8, 64], ids=["python", "native"])
def test_quad_prod_matches_reference(n):
    rng = random.Random(2)
    A, B = _rand(rng, n), _rand(rng, n)
    claim = sum(a * b for a, b in zip(A, B)) % P
    rounds = n.bit_length() - 1
    outs = []
    for SC, ML, E in ((JSC, JML, JPE), (TSC, TML, TPE)):
        t = E.new_transcript(b"q")
        pf, r, fin = SC.prove_quad_prod(F, claim, rounds, ML(F, A), ML(F, B), t)
        outs.append((_polys(pf), r, fin))
        e, r2 = pf.verify(F, claim, rounds, 2, E.new_transcript(b"q"))
        assert r2 == r and e == fin[0] * fin[1] % P
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n,tau0", [(8, None), (64, None), (64, 1)],
                         ids=["python", "native-gruen", "native-materialized"])
def test_cubic_matches_reference(n, tau0):
    """A tau of 0 or 1 makes the native loop bind the eq table instead of
    factoring it out (Gruen)."""
    rng = random.Random(3)
    rounds = n.bit_length() - 1
    taus = [rng.randrange(2, P) for _ in range(rounds)]
    if tau0 is not None:
        taus[0] = tau0
    A, B, C = _rand(rng, n), _rand(rng, n), _rand(rng, n)
    eq = JEq.evals_from_points(F, taus)
    claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, A, B, C)) % P
    t = JPE.new_transcript(b"c")
    jpf, jr, jfin = JSC.prove_cubic_with_three_inputs(
        F, claim, taus, JML(F, A), JML(F, B), JML(F, C), t)
    t = TPE.new_transcript(b"c")
    tpf, tr, tfin = TSC.prove_cubic_with_three_inputs(
        F, claim, taus, TML(F, A), TML(F, B), TML(F, C), t)
    assert (_polys(tpf), tr, tfin) == (_polys(jpf), jr, jfin)
    e, r2 = tpf.verify(F, claim, rounds, 3, TPE.new_transcript(b"c"))
    assert r2 == tr
    assert e == TEq(F, taus).evaluate(tr) * ((tfin[0] * tfin[1] - tfin[2]) % P) % P


@pytest.mark.parametrize("n", [4, 64])
def test_device_sumcheck_matches_host_and_reference(n, monkeypatch):
    """The port's device outer sumcheck (plain versions on CPU tensors)
    gives the host proof (the native Gruen loop at n = 64); at n = 4 also
    the JAX package's device sumcheck (NOVA_TPU_FORCE_DEVICE=1; each table
    size compiles its own XLA programs, so it stays small)."""
    monkeypatch.setenv("NOVA_TPU_FORCE_DEVICE", "1")
    rng = random.Random(4)
    rounds = n.bit_length() - 1
    taus = _rand(rng, rounds)
    A, B = _rand(rng, n), _rand(rng, n)
    C = [a * b % P for a, b in zip(A, B)]
    got = tops_sumcheck.prove_cubic_with_three_inputs_device(
        F, 0, taus, A, B, C, TPE.new_transcript(b"x"), device="cpu")
    host = TSC.prove_cubic_with_three_inputs(
        F, 0, taus, TML(F, A), TML(F, B), TML(F, C), TPE.new_transcript(b"x"))
    got = (_polys(got[0]), got[1], got[2])
    assert got == (_polys(host[0]), host[1], host[2])
    if n == 4:
        j = jdevice_cubic(F, 0, taus, A, B, C, JPE.new_transcript(b"x"))
        assert got == (_polys(j[0]), j[1], j[2])


def test_field_tree_sum_pads_odd_levels():
    tf = TField(F)
    vals = [random.Random(5).randrange(P) for _ in range(6)]
    m = tf.to_mont(torch.from_numpy(tf.pack(vals)))
    s = tops_sumcheck._field_tree_sum(tf, m[:5])
    assert tf.unpack(tf.from_mont(s[None]))[0] == sum(vals[:5]) % P


def test_batch_eval_matches_reference():
    rng = random.Random(6)
    jck = JCE.setup(JPE.curve, b"batch", 16)
    tck = port_key(jck)
    P1, P2 = _rand(rng, 16), _rand(rng, 4)
    x1, x2 = _rand(rng, 4), _rand(rng, 2)
    e1, e2 = JML.evaluate_with(F, P1, x1), JML.evaluate_with(F, P2, x2)
    jc = [JCE.commit(jck, P1, 0), JCE.commit(jck, P2, 0)]
    tc = [TCE.commit(tck, P1, 0), TCE.commit(tck, P2, 0)]
    assert [_pt(c) for c in tc] == [_pt(c) for c in jc]
    jres = jreduce(F, [JPEI(jc[0], x1, e1), JPEI(jc[1], x2, e2)], [JPEW(P1), JPEW(P2)],
                   JPE.new_transcript(b"b"))
    tres = treduce(F, [TPEI(tc[0], x1, e1), TPEI(tc[1], x2, e2)], [TPEW(P1), TPEW(P2)],
                   TPE.new_transcript(b"b"))
    (jbu, jbw, jcc, jscp, jev), (tbu, tbw, tcc, tscp, tev) = jres, tres
    assert (_pt(tbu.c), tbu.x, tbu.e, tcc, _polys(tscp), tev) == (
        _pt(jbu.c), jbu.x, jbu.e, jcc, _polys(jscp), jev)
    assert list(tbw.p) == list(jbw.p)
    assert TML.evaluate_with(F, list(tbw.p), tbu.x) == tbu.e
    bu2, _ = tverify(F, [TPEI(tc[0], x1, e1), TPEI(tc[1], x2, e2)],
                     TPE.new_transcript(b"b"), tscp, tev)
    assert (bu2.e, bu2.x, _pt(bu2.c)) == (tbu.e, tbu.x, _pt(tbu.c))
    with pytest.raises(Exception):
        tverify(F, [TPEI(tc[0], x1, e1), TPEI(tc[1], x2, (e2 + 1) % P)],
                TPE.new_transcript(b"b"), tscp, tev)


@pytest.mark.parametrize("engines", [(JPE, TPE, TPALLAS), (JVE, TVE, TVESTA)],
                         ids=["pallas", "vesta"])
@pytest.mark.parametrize("loop", ["native", "python"])
def test_ipa_matches_reference(engines, loop, monkeypatch):
    je, te, tcurve = engines
    f = je.scalar
    rng = random.Random(7)
    jck = JCE.setup(je.curve, b"ipa-test", 16)
    tck = port_key(jck, tcurve)
    poly = [rng.randrange(f.p) for _ in range(16)]
    point = [rng.randrange(f.p) for _ in range(4)]
    ev = JML.evaluate_with(f, poly, point)
    jcomm = JCE.commit(jck, poly, 0)
    tcomm = _tcomm(jcomm, tcurve)
    jpk, jvk = JIPA.setup(je, jck)
    jarg = JIPA.prove(je, jck, jpk, je.new_transcript(b"ipa"), jcomm, poly, point, ev)
    if loop == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    tpk, tvk = TIPA.setup(te, tck)
    targ = TIPA.prove(te, tck, tpk, te.new_transcript(b"ipa"), tcomm, poly, point, ev)
    assert ([_pt(L) for L in targ.L_vec], [_pt(R) for R in targ.R_vec], targ.a_hat) == (
        [_pt(L) for L in jarg.L_vec], [_pt(R) for R in jarg.R_vec], jarg.a_hat)
    TIPA.verify(te, tvk, te.new_transcript(b"ipa"), tcomm, point, ev, targ)
    with pytest.raises(Exception):
        TIPA.verify(te, tvk, te.new_transcript(b"ipa"), tcomm, point, (ev + 1) % f.p, targ)


def test_key_ops_match_reference():
    """IPA's commitment-key operations (split_at, combine, fold, scale; the
    native binding's ec_fold/ec_scale) give the JAX package's points, and
    the host marshalling is shared with the prefix a split returns."""
    jck = JCE.setup(JPE.curve, b"ipa-test", 16)
    tck = port_key(jck)

    def pts(ck):
        return [g.to_coordinates() for g in ck.ck]

    tl, tr = tck.split_at(8)
    jl, jr = jck.split_at(8)
    assert (pts(tl), pts(tr)) == (pts(jl), pts(jr))
    assert pts(tl.combine(tr)) == pts(tck)
    assert pts(tck.fold(5, 7)) == pts(jck.fold(5, 7))
    assert pts(tck.scale(11)) == pts(jck.scale(11))
    arrs = tck.host_arrays(16)
    assert tck.split_at(4)[0].host_arrays(4) is arrs


def snark_fields(s):
    """Every field of a RelaxedR1CSSNARK, as plain ints and coordinates."""
    a = s.eval_arg
    return (_polys(s.sc_proof_outer), list(s.claims_outer), s.eval_E,
            _polys(s.sc_proof_inner), s.eval_W, _polys(s.sc_proof_batch),
            list(s.evals_batch), [_pt(L) for L in a.L_vec], [_pt(R) for R in a.R_vec],
            a.a_hat)


def _derandomized_pair(r1cs, S, ck, x, r_W):
    """tests/test_spartan.py's instance: the cubic witness for x, relaxed
    and derandomized."""
    f = F
    z0 = f.mul(x, x)
    z1 = f.mul(z0, x)
    z2 = f.add(z1, x)
    W = r1cs.R1CSWitness.new(S, [z0, z1, z2, 0], r_W=r_W)
    U = r1cs.R1CSInstance.new(S, W.commit(ck), [x, f.add(z2, 5)])
    rU = r1cs.RelaxedR1CSInstance.from_r1cs_instance(ck.curve, S, U)
    rW = r1cs.RelaxedR1CSWitness.from_r1cs_witness(S, W)
    drW, bW, bE = rW.derandomize()
    dk = (JCE if r1cs is jr1cs else TCE).derand_key(ck)
    return rU.derandomize(dk, bW, bE), drW


@pytest.mark.parametrize("num_vars,device", [(4, False), (64, False), (64, True)],
                         ids=["python", "native", "device-outer"])
def test_snark_matches_reference(num_vars, device, monkeypatch):
    """RelaxedR1CSSNARK on the tiny cubic R1CS (num_vars pads it to 4 or 64
    constraints): equal proofs, the port's verify passes and a tampered
    instance or evaluation fails. `device` forces the port's device outer
    sumcheck (DEVICE_THRESHOLD lowered while proving)."""
    jS = tiny_r1cs(JPE, num_vars=num_vars)
    jck = jS.commitment_key(b"ck", 0)
    tS, tck = port_shape(jS), port_key(jck)
    jU, jW = _derandomized_pair(jr1cs, jS, jck, 3, 1001)
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 3, 1001)
    assert (_pt(tU.comm_W), tU.X, tU.u) == (_pt(jU.comm_W), jU.X, jU.u)
    jpk, jvk = JSNARK.setup(JPE, jck, jS)
    tpk, tvk = TSNARK.setup(TPE, tck, tS)
    assert tpk.vk_digest == jpk.vk_digest
    jproof = JSNARK.prove(JPE, jck, jpk, jS, jU, jW)
    calls = []
    with monkeypatch.context() as m:
        if device:
            m.setattr(constants, "DEVICE_THRESHOLD", 1)
            real = tops_sumcheck.prove_cubic_with_three_inputs_device
            m.setattr(tops_sumcheck, "prove_cubic_with_three_inputs_device",
                      lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
        tproof = TSNARK.prove(TPE, tck, tpk, tS, tU, tW)
    assert calls == ([tck.device] if device else [])
    assert snark_fields(tproof) == snark_fields(jproof)
    tproof.verify(tvk, tU)
    bad = tr1cs.RelaxedR1CSInstance(tU.comm_W, tU.comm_E, list(tU.X), (tU.u + 1) % P)
    with pytest.raises(Exception):
        tproof.verify(tvk, bad)
    tampered = copy.copy(tproof)
    tampered.eval_W = (tproof.eval_W + 1) % P
    with pytest.raises(Exception):
        tampered.verify(tvk, tU)
