"""The port's native host binding (``nova_tpu_torch.native``, its own build
of ``native/nova_native.cpp`` under ``nova_tpu_torch/_build/``) against the
JAX package's binding on CPU, on small seeded inputs over both Pallas and
Vesta fields and curves. Tolerance: exact (limb arrays equal, points
equal)."""

import os

import numpy as np
import pytest

from nova_tpu import native as jn
from nova_tpu.curves.spec import pallas as JPALLAS, vesta as JVESTA
from nova_tpu.provider.pedersen import CommitmentEngine as JCE

from nova_tpu_torch import native as tn
from nova_tpu_torch.curves.spec import pallas as TPALLAS, vesta as TVESTA

CURVES = [(JPALLAS, TPALLAS), (JVESTA, TVESTA)]
IDS = ["pallas", "vesta"]


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert jn.available() and tn.available()


def _limbs(rng, p, n):
    return tn.ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)])


def test_build_lands_in_the_port():
    from nova_tpu_torch import _build

    so = tn._build()
    assert so.startswith(_build.BUILD_ROOT + os.sep)
    assert os.path.basename(os.path.dirname(so)).startswith("native-")


@pytest.mark.parametrize("curves", CURVES, ids=IDS)
def test_field_ops_match(curves):
    jc, tc = curves
    p = tc.scalar.p
    rng = np.random.default_rng(5)
    a, b, c, d = (_limbs(rng, p, 64) for _ in range(4))
    r1, r2 = (int.from_bytes(rng.bytes(32), "little") % p for _ in range(2))
    np.testing.assert_array_equal(tn.vec_fold_l(p, a, b, r1, r2), jn.vec_fold_l(p, a, b, r1, r2))
    np.testing.assert_array_equal(tn.vec_bind_l(p, a, r1), jn.vec_bind_l(p, a, r1))
    np.testing.assert_array_equal(tn.vec_axpy_l(p, a, b, r2), jn.vec_axpy_l(p, a, b, r2))
    np.testing.assert_array_equal(tn.vec_mulmod_l(p, a, b), jn.vec_mulmod_l(p, a, b))
    assert tn.vec_dot_l(p, a, b) == jn.vec_dot_l(p, a, b)
    taus = [int(x) for x in tn.limbs_to_ints(c[:9])]
    np.testing.assert_array_equal(tn.eq_evals_l(p, taus), jn.eq_evals_l(p, taus))
    assert tn.sumcheck_cubic_round_l(p, a, b, c, d) == jn.sumcheck_cubic_round_l(p, a, b, c, d)
    assert tn.sumcheck_quad_round_l(p, a, b) == jn.sumcheck_quad_round_l(p, a, b)
    assert (tn.sumcheck_cubic_gruen_round_l(p, a[:32], a, b, c)
            == jn.sumcheck_cubic_gruen_round_l(p, a[:32], a, b, c))
    vals = tn.limbs_to_ints(a)
    assert tn.batch_inv_ints(p, vals) == jn.batch_inv_ints(p, vals)


@pytest.mark.parametrize("curves", CURVES, ids=IDS)
def test_msm_cached_index_subset_matches(curves):
    jc, tc = curves
    jck = JCE.setup(jc, b"ipa-test", 16)  # 17 generators
    pts = [(g.x, g.y, g.infinity) for g in jck.ck]
    from nova_tpu_torch.curves.spec import AffinePoint

    tpts = [AffinePoint(tc, x, y, inf) for x, y, inf in pts]
    rng = np.random.default_rng(9)
    idx = [int(i) for i in rng.permutation(len(tpts))[:7]] + [3]
    scal = _limbs(rng, tc.scalar.p, len(idx))
    want = jn.msm_cached(jc, jn.marshal_points(jck.ck), scal, idx)
    got = tn.msm_cached(tc, tn.marshal_points(tpts), scal, idx)
    assert got.to_coordinates() == want.to_coordinates()
    ints = tn.limbs_to_ints(scal[:5])
    assert (tn.msm_cached(tc, tn.marshal_points(tpts), ints).to_coordinates()
            == jn.msm_cached(jc, jn.marshal_points(jck.ck), ints).to_coordinates())
    w1, w2 = 12345, 678910
    half = len(tpts) // 2
    assert ([q.to_coordinates() for q in tn.ec_fold(tpts[:half], tpts[half:], w1, w2)]
            == [q.to_coordinates() for q in jn.ec_fold(jck.ck[:half], jck.ck[half:], w1, w2)])
    assert ([q.to_coordinates() for q in tn.ec_scale(tpts, w2)]
            == [q.to_coordinates() for q in jn.ec_scale(jck.ck, w2)])


def test_spmv_matches():
    p = TPALLAS.scalar.p
    rng = np.random.default_rng(12)
    rows, cols = 40, 30
    indptr = [0]
    indices, data = [], []
    for _ in range(rows):
        cs = sorted(set(int(c) for c in rng.integers(0, cols, 5)))
        indices += cs
        data += [(1, p - 1)[k] if k < 2 else int.from_bytes(rng.bytes(32), "little") % p
                 for k in range(len(cs))]
        indptr.append(len(indices))
    z = _limbs(rng, p, cols)
    got = tn.spmv_l(p, tn.marshal_matrix(p, data, indices, indptr), z)
    want = jn.spmv_l(p, jn.marshal_matrix(p, data, indices, indptr), z)
    np.testing.assert_array_equal(got, want)
