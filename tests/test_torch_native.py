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


# -- the bindings added with the fold step's native routes and HyperKZG ------

from nova_tpu.curves.spec import bn254 as JBN, grumpkin as JGR  # noqa: E402
from nova_tpu_torch.curves.spec import bn254 as TBN, grumpkin as TGR  # noqa: E402

ALL_CURVES = CURVES + [(JBN, TBN), (JGR, TGR)]
ALL_IDS = IDS + ["bn254", "grumpkin"]


def _ints(rng, p, n):
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


@pytest.mark.parametrize("curves", ALL_CURVES, ids=ALL_IDS)
def test_vector_bindings_match(curves):
    """vec_addmod_l, vec_cross_l, vec_cross_relaxed_l, vec_sat_check_l,
    vec_from_mont_l, vec_mulmod, vec_invmod and inv_mod."""
    _, tc = curves
    p = tc.scalar.p
    rng = np.random.default_rng(31)
    az, bz, cz, e1, az2, bz2, cz2, e2 = (_limbs(rng, p, 48) for _ in range(8))
    u1, u2 = _ints(rng, p, 2)
    np.testing.assert_array_equal(tn.vec_addmod_l(p, az, bz), jn.vec_addmod_l(p, az, bz))
    np.testing.assert_array_equal(tn.vec_cross_l(p, az, bz, cz, e1, u1),
                                  jn.vec_cross_l(p, az, bz, cz, e1, u1))
    args = (p, az, bz, cz, az2, bz2, cz2, e1, e2, u1, u2)
    np.testing.assert_array_equal(tn.vec_cross_relaxed_l(*args), jn.vec_cross_relaxed_l(*args))
    # E = az*bz - u*cz on the first 40 rows: 8 unsatisfied rows
    sat = tn.vec_cross_l(p, az, bz, cz, np.zeros_like(az), u1)
    e = np.vstack([sat[:40], e1[40:]])
    assert tn.vec_sat_check_l(p, az, bz, cz, e, u1) == jn.vec_sat_check_l(p, az, bz, cz, e, u1) == 8
    mont = _limbs(rng, p, 48)
    np.testing.assert_array_equal(tn.vec_from_mont_l(p, mont), jn.vec_from_mont_l(p, mont))
    a, b = _ints(rng, p, 20), _ints(rng, p, 20)
    assert tn.vec_mulmod(p, a, b) == jn.vec_mulmod(p, a, b)
    assert tn.vec_invmod(p, a) == jn.vec_invmod(p, a)
    assert [tn.inv_mod(p, x) for x in a] == [jn.inv_mod(p, x) for x in a]
    assert tn.inv_mod(p, a[0]) * a[0] % p == 1


@pytest.mark.parametrize("curves", CURVES, ids=IDS)
def test_round_and_poly_bindings_match(curves):
    """sumcheck_cubicprod/quadeval/linear rounds, neutron_round_l,
    poly_eval_horner_l, poly_div_linear_l and ntt_l."""
    _, tc = curves
    p = tc.scalar.p
    rng = np.random.default_rng(37)
    A, B, C, D = (_limbs(rng, p, 64) for _ in range(4))
    assert tn.sumcheck_cubicprod_round_l(p, A, B, C) == jn.sumcheck_cubicprod_round_l(p, A, B, C)
    assert tn.sumcheck_quadeval_round_l(p, A, B) == jn.sumcheck_quadeval_round_l(p, A, B)
    assert tn.sumcheck_linear_round_l(p, A, B) == jn.sumcheck_linear_round_l(p, A, B)
    tabs = [_limbs(rng, p, 32) for _ in range(8)]
    assert (tn.neutron_round_l(p, *tabs, 4, 8) == jn.neutron_round_l(p, *tabs, 4, 8))
    u = _ints(rng, p, 1)[0]
    assert tn.poly_eval_horner_l(p, A, u) == jn.poly_eval_horner_l(p, A, u)
    np.testing.assert_array_equal(tn.poly_div_linear_l(p, A, u), jn.poly_div_linear_l(p, A, u))
    # a 64th root of unity: the multiplicative generator 5 to the (p-1)/64
    root = pow(5, (p - 1) // 64, p)
    for inv in (False, True):
        np.testing.assert_array_equal(tn.ntt_l(p, D, root, inv), jn.ntt_l(p, D, root, inv))
    back = tn.ntt_l(p, tn.ntt_l(p, D, root), root, True)  # inverts the root itself
    np.testing.assert_array_equal(back, D)


@pytest.mark.parametrize("curves", ALL_CURVES, ids=ALL_IDS)
def test_point_bindings_match(curves):
    """msm, ec_mul_many, ec_fixed_mul_many and batch_add_seg, as affine
    coordinates."""
    from nova_tpu.curves.spec import AffinePoint as JA
    from nova_tpu_torch.curves.spec import AffinePoint as TA

    jc, tc = curves
    rng = np.random.default_rng(41)
    ks = _ints(rng, tc.scalar.p, 24)
    jpts = [JA.generator(jc).mul(k) for k in ks[:12]] + [JA.identity(jc)]
    tpts = [TA(tc, q.x, q.y, q.infinity) for q in jpts]
    sc = ks[12:] + [7]

    def xy(points):
        return [q.to_coordinates() for q in points]

    assert tn.msm(sc, tpts).to_coordinates() == jn.msm(sc, jpts).to_coordinates()
    assert xy(tn.ec_mul_many(tpts, sc)) == xy(jn.ec_mul_many(jpts, sc))
    tg, jg = TA.generator(tc), JA.generator(jc)
    assert xy(tn.ec_fixed_mul_many(tg, sc)) == xy(jn.ec_fixed_mul_many(jg, sc))
    order = [int(i) for i in rng.permutation(len(tpts))] + [0, 0]
    off = [0, 3, 4, 9, len(order)]
    assert (xy(tn.batch_add_seg(tc, tn.marshal_points(tpts), order, off))
            == xy(jn.batch_add_seg(jc, jn.marshal_points(jpts), order, off)))


def test_keccak_lanes_match():
    rng = np.random.default_rng(43)
    lanes = [[int(v) for v in rng.integers(0, 1 << 63, 5, dtype=np.uint64)] for _ in range(5)]
    from nova_tpu_torch.provider.keccak import keccak_f1600

    assert tn.keccak_f1600_lanes(lanes) == jn.keccak_f1600_lanes(lanes) == keccak_f1600(lanes)


@pytest.mark.parametrize("curves", ALL_CURVES, ids=ALL_IDS)
def test_poseidon_bindings_match(curves):
    """poseidon_ctx, poseidon_permute and poseidon_permute_witness (both
    compact modes) on the RO constants of each scalar field."""
    from nova_tpu.provider.poseidon import PoseidonROConstants as JRO
    from nova_tpu_torch.provider.poseidon import PoseidonROConstants as TRO

    jc, tc = curves
    p = tc.scalar.p
    rng = np.random.default_rng(47)

    def ctx(nat, k):
        return nat.poseidon_ctx(p, k.width, k.half_full_rounds, k.partial_rounds,
                                k.compressed_round_constants, k.m, k.pre_sparse_matrix,
                                k.sparse_matrixes)

    for which in ("wide", "narrow"):
        jk, tk = getattr(JRO(jc.scalar), which), getattr(TRO(tc.scalar), which)
        el = _ints(rng, p, tk.width)
        th, jh = ctx(tn, tk), ctx(jn, jk)
        assert (tn.poseidon_permute(th, p, el, tk.width)
                == jn.poseidon_permute(jh, p, el, jk.width))
        for compact in (False, True):
            got = tn.poseidon_permute_witness(th, p, el, tk.width, tk.full_rounds,
                                              tk.partial_rounds, compact)
            want = jn.poseidon_permute_witness(jh, p, el, jk.width, jk.full_rounds,
                                               jk.partial_rounds, compact)
            assert got == want
