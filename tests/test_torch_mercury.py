"""The port's Mercury evaluation engine (``nova_tpu_torch.provider.mercury``)
against the JAX package on CPU: its field and polynomial helpers (the
two-adic root, omega, the NTT through the native binding and in Python,
eval_pu_poly, the binomial division, the s-polynomial), Mercury arguments
at ell 4 and 5 (an odd ell pads), and an IVC-level compression with
snark + Mercury on the BN254 primary and IPA on the Grumpkin secondary,
mirroring tests/test_ivc_matrix.py::test_ivc_with_mercury_compression on
tests/test_torch_hyperkzg_ivc.py's cubic circuit and power-14 test ptau.

Keys are carried across with ``interop.kzg_commitment_key``; inputs come
from seeded generators; ``secrets.randbelow`` is patched to one seeded
generator restarted for each package in the IVC test. Tolerance: exact
(every argument field equal; commitments as affine points)."""

import random

import pytest
import torch

from nova_tpu.frontend.constraint_system import ONE as JONE, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import StepCircuit as JStep
from nova_tpu.nova.compressed import CompressedSNARK as JCS
from nova_tpu.nova.ivc import RecursiveSNARK as JRS
from nova_tpu.provider import mercury as jm
from nova_tpu.provider.engines import Bn256EngineIPA as JBN
from nova_tpu.provider.hyperkzg import setup_insecure
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
from nova_tpu.spartan.polys import EqPolynomial as JEq, MultilinearPolynomial as JML

from nova_tpu_torch import interop, native as tnative
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.nova.compressed import CompressedSNARK as TCS
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.provider import mercury as tm
from nova_tpu_torch.provider.engines import Bn256EngineIPA as TBN
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

from tests.test_torch_fold import key_rows
from tests.test_torch_hyperkzg_ivc import STEPS, _compress, kzg_pp  # noqa: F401  (fixture)
from tests.test_torch_hyperkzg_ivc import _proof_fields
from tests.test_torch_ivc import cubic
from tests.test_torch_spartan import _pt

torch.set_num_threads(1)

F = JBN.scalar
P = F.p


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


@pytest.mark.parametrize("route", ["native", "python"])
def test_helpers_match_reference(route, monkeypatch):
    rng = random.Random(9)
    assert tm._two_adic_root(P) == jm._two_adic_root(P)
    assert [tm.omega(P, k) for k in (1, 4, 7, 28)] == [jm.omega(P, k) for k in (1, 4, 7, 28)]
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    for log_n in (4, 6, 7):  # the binding takes n >= 64
        a = _rand(rng, 1 << log_n)
        w = jm.omega(P, log_n)
        ta, ja = list(a), list(a)
        tm.ntt(ta, w, log_n, P)
        jm.ntt(ja, w, log_n, P)
        assert ta == ja
        tm.ntt(ta, pow(w, -1, P), log_n, P)
        assert [x * pow(1 << log_n, -1, P) % P for x in ta] == a
    f, x = _rand(rng, 70), rng.randrange(P)
    assert tm._poly_eval(f, x, P) == jm._poly_eval(f, x, P)
    tf, jf = list(f), list(f)
    assert tm._div_linear(tf, x, P) == jm._div_linear(jf, x, P) and tf == jf
    xs, ys = _rand(rng, 3), _rand(rng, 3)
    assert tm._interp(xs, ys, P) == jm._interp(xs, ys, P)
    u = _rand(rng, 5)
    assert tm.eval_pu_poly(u, x, P) == jm.eval_pu_poly(u, x, P)
    coeffs, alpha = _rand(rng, 64), rng.randrange(P)
    assert tm._divide_by_binomial(coeffs, 8, 8, alpha, P) == jm._divide_by_binomial(
        coeffs, 8, 8, alpha, P)
    eq_col = JEq.evals_from_points(F, _rand(rng, 3))
    assert tm._compute_h_poly(coeffs, eq_col, 8, 8, P) == jm._compute_h_poly(
        coeffs, eq_col, 8, 8, P)
    a_polys, b_polys, gamma = (_rand(rng, 8), _rand(rng, 8)), (_rand(rng, 8), _rand(rng, 8)), 5
    assert tm._make_s_polynomial(a_polys, b_polys, 3, gamma, P) == jm._make_s_polynomial(
        a_polys, b_polys, 3, gamma, P)


def mercury_fields(a):
    """Every field of a Mercury EvaluationArgument."""
    return {k: (_pt(v) if hasattr(v, "point") else v) for k, v in vars(a).items()}


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("ell", [4, 5])
def test_mercury_matches_reference(ell, route, monkeypatch):
    rng = random.Random(ell)
    n = 1 << ell
    jck, tau_H = setup_insecure(2 * n)
    tck = interop.kzg_commitment_key(key_rows(jck), (tau_H.x, tau_H.y), "cpu")
    poly, point = _rand(rng, n), _rand(rng, ell)
    ev = JML.evaluate_with(F, poly, point)
    jc = JCE.commit(jck, poly, 0)
    jpk, jvk = jm.EvaluationEngine.setup(JBN, jck)
    jarg = jm.EvaluationEngine.prove(JBN, jck, jpk, JBN.new_transcript(b"m"), jc, poly,
                                     point, ev)
    if route == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    tc = TCE.commit(tck, poly, 0)
    assert _pt(tc) == _pt(jc)
    tpk, tvk = tm.EvaluationEngine.setup(TBN, tck)
    targ = tm.EvaluationEngine.prove(TBN, tck, tpk, TBN.new_transcript(b"m"), tc, poly,
                                     point, ev)
    assert mercury_fields(targ) == mercury_fields(jarg)
    tm.EvaluationEngine.verify(TBN, tvk, TBN.new_transcript(b"m"), tc, point, ev, targ)
    with pytest.raises(NovaError):
        tm.EvaluationEngine.verify(TBN, tvk, TBN.new_transcript(b"m"), tc, point,
                                   (ev + 1) % P, targ)


def test_ivc_with_mercury_compression_matches_reference(kzg_pp, monkeypatch):  # noqa: F811
    jpp, tpp, _ = kzg_pp
    j, jvk, jzi = _compress(jpp, JRS, JCS, jm.EvaluationEngine, cubic(JStep, JNum, JONE, jlc),
                            29, monkeypatch)
    t, tvk, tzi = _compress(tpp, TRS, TCS, tm.EvaluationEngine,
                            cubic(TStep, TNum, TONE, tlc), 29, monkeypatch)
    assert tzi == jzi
    tf, jf = _proof_fields(t, mercury_fields), _proof_fields(j, mercury_fields)
    assert tf == jf
    assert t.verify(tvk, STEPS, [2]) == tzi
    zn = list(t.zn)
    t.zn = [(z + 1) % P for z in zn]
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
    t.zn = zn
    arg = t.snark_primary.eval_arg
    arg.g_zeta = (arg.g_zeta + 1) % P  # one Mercury argument field changed
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
