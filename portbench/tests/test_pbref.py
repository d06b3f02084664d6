"""The plain reference against direct computations at tiny sizes."""

import random

import pytest

from pbref import h2c
from pbref.checks import commit_ref
from pbref.curves import CURVES, add, combine, mul, sqrt
from pbref.msm import msm_rows, pippenger
from pbref.r1cs import unsat_rows


@pytest.mark.parametrize("name", sorted(CURVES))
def test_sqrt_roots_and_non_residues(name):
    p = CURVES[name].p
    rng = random.Random(1)
    for _ in range(20):
        x = rng.randrange(1, p)
        y = sqrt(x * x, p)
        assert y * y % p == x * x % p
        r = sqrt(x, p)
        assert (r is None) == (pow(x, (p - 1) // 2, p) != 1)
        if r is not None:
            assert r * r % p == x


@pytest.mark.parametrize("name", sorted(CURVES))
def test_generators_on_curve_and_group_law(name):
    curve = CURVES[name]
    G, H = h2c.from_rows(h2c.derive_rows(name, b"pbref-test", 2))
    assert curve.on_curve(G) and curve.on_curve(H)
    assert mul(curve, G, 5) == add(curve, add(curve, G, G), mul(curve, G, 3))
    assert mul(curve, G, curve.r) is None
    assert add(curve, G, mul(curve, G, curve.r - 1)) is None


@pytest.mark.parametrize("name", sorted(CURVES))
def test_generators_match_the_program(name):
    """The generators derived again equal the program's own derivation."""
    from nova_tpu_torch.curves.spec import ALL_CURVES
    from nova_tpu_torch.provider.pedersen import from_label

    mine = h2c.from_rows(h2c.derive_rows(name, b"ck", 6))
    port = [(P.x, P.y) for P in from_label(ALL_CURVES[name], b"ck", 6)]
    assert mine == port


@pytest.mark.parametrize("n", [1, 7, 300])
def test_msm_equals_sum_of_products(n):
    curve = CURVES["pallas"]
    rows = h2c.derive_rows("pallas", b"pbref-msm", n)
    pts = h2c.from_rows(rows)
    rng = random.Random(n)
    s = [rng.randrange(curve.r) for _ in range(n)]
    s[0] = 0
    want = combine(curve, zip(s, pts))
    assert msm_rows("pallas", rows, s, workers=1) == want
    assert msm_rows("pallas", rows, s, workers=2) == want


def test_pippenger_repeated_points_and_cancellation():
    from pbref.curves import xyzz_to_affine

    curve = CURVES["vesta"]
    G = h2c.from_rows(h2c.derive_rows("vesta", b"pbref-rep", 1))[0]
    acc = pippenger(curve.p, [G, G, G], [3, 5, curve.r - 8], curve.r.bit_length())
    assert xyzz_to_affine(curve.p, acc) is None
    acc = pippenger(curve.p, [G, G], [2, 2], curve.r.bit_length())
    assert xyzz_to_affine(curve.p, acc) == mul(curve, G, 4)


def test_unsat_rows_counts_broken_rows():
    p = 101
    # rows: w0 * w0 = w1 ; w1 * u = w2 (z = w0, w1, w2, u, x0)
    A = ([1, 1], [0, 1], [0, 1, 2])
    B = ([1, 1], [0, 3], [0, 1, 2])
    C = ([1, 1], [1, 2], [0, 1, 2])
    assert unsat_rows(p, A, B, C, [3, 9, 9], 1, [0]) == 0
    assert unsat_rows(p, A, B, C, [3, 10, 9], 1, [0]) == 2
    # relaxed: u = 2, E makes up the difference
    assert unsat_rows(p, A, B, C, [3, 9, 18], 2, [0], E=[(9 - 18) % p, (18 - 36) % p]) == 0


def test_ptau_commitment_is_evaluation_at_tau():
    curve = CURVES["bn254"]
    tau = 123456789
    v = [5, 0, 7, 11]
    blind = 99
    pts = [mul(curve, curve.gen, pow(tau, i, curve.r)) for i in range(len(v))]
    h = h2c.from_rows(h2c.key_rows("bn254", b"h", 1))[0]
    want = add(curve, combine(curve, zip(v, pts)), mul(curve, h, blind))
    assert commit_ref("bn254", {"kind": "ptau", "tau": tau}, v, blind) == want


def _chain_shape(n, drop=None):
    """CSR matrices of n squaring rows v_k * v_k = v_{k+1} between two
    other rows, the row `drop` of the chain left out."""
    rows = [([(0, 2), (3, 1)], [(1, 1)], [(2, 5)])]  # not a squaring
    for k in range(n):
        if k != drop:
            rows.append(([(10 + k, 1)], [(10 + k, 1)], [(11 + k, 1)]))
    rows.append(([(4, 1)], [(4, 1)], [(5, 3)]))  # a square with a coefficient
    mats = []
    for m in range(3):
        data, idx, ptr = [], [], [0]
        for r in rows:
            for i, c in r[m]:
                idx.append(i)
                data.append(c)
            ptr.append(len(idx))
        mats.append((data, idx, ptr))
    return mats


def test_step_rows_missing_counts_the_chain():
    from pbref import steps

    sq = steps.load("squares")
    assert sq.rows_missing(*_chain_shape(40), {"squares": 40}) == 0
    assert sq.rows_missing(*_chain_shape(40, drop=30), {"squares": 40}) == 10
    assert sq.rows_missing(*_chain_shape(39), {"squares": 40}) == 1
    assert sq.rows_missing(*_chain_shape(41), {"squares": 40}) == 1
    assert sq.z_out([3], 2, {"squares": 5}, 101) == [pow(3, 2**10, 101)]
