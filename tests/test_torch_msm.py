"""The port's fixed-base MSM (plain K4/K5 on CPU) against nova_tpu.ops.msm3
on CPU (its XLA path, window 9) and the host Pippenger.

Bases, their precompute and scalars are carried across with
nova_tpu_torch.interop, so both packages compute on the same state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_tpu.curves import jpoints
from nova_tpu.curves.msm_host import msm as host_msm
from nova_tpu.curves.spec import AffinePoint, pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.ops import msm3 as jmsm3
from nova_tpu.ops.fvec import FVec as JFVec
from nova_tpu.ops.msm2 import DeviceBases2 as JDeviceBases2

from nova_tpu_torch import interop
from nova_tpu_torch.curves.points import xyzz_add as xyzz_add_port
from nova_tpu_torch.curves.spec import pallas as TCURVE
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm2, msm3
from nova_tpu_torch.ops.fvec import FVec

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

KEYS = ("x", "y", "zz", "zzz")
C9 = 9  # window on CPU (the reference's XLA path caps at 9)


def _bases(n):
    g = AffinePoint.generator(JCURVE)
    out, acc = [], g
    for _ in range(n):
        out.append(acc)
        acc = acc.add(g)
    return out


def _port_db(jdb, n_pad):
    """Port DeviceBases2 on CPU with the reference's precompute installed."""
    tdb = interop.device_bases2(
        TCURVE, np.asarray(jdb.x), np.asarray(jdb.y), np.asarray(jdb.inf), "cpu"
    )
    fx, fy, finf = jmsm3._fixed3_host(jdb, C9, n_pad)
    interop.set_fixed(tdb, C9, n_pad, np.asarray(fx), np.asarray(fy), np.asarray(finf))
    return tdb


def _xy(p):
    return (p.x, p.y, p.infinity)


@pytest.fixture(scope="module")
def case():
    n = 500
    bases = _bases(n)
    rng = np.random.default_rng(7)
    order = JCURVE.scalar.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % order for _ in range(n)]
    jdb = JDeviceBases2(JCURVE, bases)
    return {
        "bases": bases, "scalars": scalars, "jdb": jdb, "tdb": _port_db(jdb, 512),
        "want": _xy(host_msm(scalars, bases)),
    }


def _mont(scalars):
    return FVec.from_ints(TCURVE.scalar, scalars, device="cpu").m


def test_msm_device3_mont_matches_reference_and_host(case):
    jf = JField(JCURVE.scalar)
    jm = JFVec.from_ints(jf, case["scalars"]).m
    ref = jmsm3.msm_device3_mont(jm, case["jdb"], window=C9)
    got = msm3.msm_device3_mont(interop.limbs(np.asarray(jm), "cpu"), case["tdb"], window=C9)
    assert _xy(got) == _xy(ref) == case["want"]


def test_precompute_matches_reference(case):
    tf = TField(TCURVE.base)
    bx, by, binf = msm2._sized(case["tdb"], 512)
    fx, fy, finf = msm2._precompute_shifted(tf, C9, 3, bx, by, binf)
    jfx, jfy, jfinf = jmsm3._fixed3_host(case["jdb"], C9, 512)
    k = 3 * 512
    assert np.array_equal(fx.numpy(), np.asarray(jfx)[:k].astype(np.int32))
    assert np.array_equal(fy.numpy(), np.asarray(jfy)[:k].astype(np.int32))
    assert np.array_equal(finf.numpy(), np.asarray(jfinf)[:k])


def test_digit_pipeline_bitwise():
    sf_j, sf_t = JField(JCURVE.scalar), TField(TCURVE.scalar)
    p = JCURVE.scalar.p
    rng = np.random.default_rng(2)
    vals = [0, 1, p - 1, p // 2, p // 2 + 1] + [
        int.from_bytes(rng.bytes(32), "little") % p for _ in range(59)
    ]
    s16 = sf_j.pack(vals)
    jabs, jneg = jmsm3._sym_reduce_device(sf_j, jnp.asarray(s16))
    tabs, tneg = msm3._sym_reduce_device(sf_t, torch.from_numpy(s16.astype(np.int32)))
    assert np.array_equal(np.asarray(jabs), tabs.numpy())
    assert np.array_equal(np.asarray(jneg), tneg.numpy())
    for c, W in ((16, 16), (9, 29), (16, 2)):
        ju = jmsm3.add_offset_device(jabs, c, W)
        tu = msm3.add_offset_device(tabs, c, W)
        assert np.array_equal(np.asarray(ju), tu.numpy())
        jd = jmsm3.offset_digits_device(ju, c, W, jneg)
        td = msm3.offset_digits_device(tu, c, W, tneg)
        assert np.array_equal(np.asarray(jd), td.numpy())
    ul = jmsm3._scalar_ulimbs(vals[:10], 16, 9, 29)
    assert np.array_equal(ul, msm3._scalar_ulimbs(vals[:10], 16, 9, 29))


# K4 over 4,096 sorted cells: on the (32, 128) grid that _sortpack picks,
# C <= 256 finishes with one suffix pass; on a (4, 1024) grid, C > 256 takes
# the level-2 accumulate, whose (8, 128) grid is the JAX package's own. So
# the per-bucket totals of the two packages compare bit for bit on both.
K4_N = 4096
K4_NB = 256


def _rand_fe(rng, n):
    """(n, 16) uint32 limbs of random field elements (< 2^254 < p)."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] &= 0x3FFF
    return limbs.astype(np.uint32)


@pytest.fixture(scope="module")
def k4_case():
    """Signed digits with long and short runs, a few infinity bases, and
    random field elements as coordinates (the formulas are algebraic, so
    no add is degenerate), sorted by the port's _sortpack."""
    n = K4_N
    rng = np.random.default_rng(4)
    absd = np.concatenate([rng.integers(0, 6, n - 1200), rng.integers(0, K4_NB + 1, 1200)])
    d = (rng.permutation(absd) * rng.choice([-1, 1], n)).astype(np.int32)
    finf = rng.random(n) < 0.01
    tf = TField(TCURVE.base)
    x, y = _rand_fe(rng, n), _rand_fe(rng, n)
    yneg = msm2._negate_y(tf, torch.from_numpy(y.astype(np.int32))).numpy().astype(np.uint32)
    zz, zzz = _rand_fe(rng, n), _rand_fe(rng, n)
    zz[::29] = 0  # a few XYZZ identities
    host = {"x": x, "y": y, "yneg": yneg, "zz": zz, "zzz": zzz, "d": d}
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in host.items()}
    sorted_d, st = msm3._sortpack(t["d"], t["x"], t["y"], t["yneg"], torch.from_numpy(finf))
    return {"tf": tf, "sorted_d": sorted_d, "st": st, "t": t, "host": host}


def _jax_totals(c, grid, xyzz: bool):
    """msm3._accum_xla on the same sorted cells laid out as the JAX
    package's column-major grids, then msm3._bucket_totals."""
    R, C = grid
    h = c["host"]
    cm = np.arange(R * C).reshape(C, R).T  # grid cell (i, j) <- position j*R + i
    rows = c["st"]["src"].numpy()[cm]
    if xyzz:
        coords = [h[k][rows] for k in KEYS]
    else:
        neg = (h["d"][rows] < 0)[..., None]
        coords = [h["x"][rows], np.where(neg, h["yneg"][rows], h["y"][rows])]
    jf = JField(JCURVE.base)
    sd = jnp.asarray(c["sorted_d"].numpy())
    d_cm = sd[jnp.asarray(cm)]
    fl, ce, _ = jmsm3._accum_xla(jf, d_cm, *(jnp.asarray(v) for v in coords[:2]), "complete",
                                 *(jnp.asarray(v) for v in coords[2:]))
    tot = jmsm3._bucket_totals(jf, sd, fl, ce, d_cm, R, C, C, K4_NB, False, "complete")
    return {k: np.asarray(v).astype(np.int32) for k, v in tot.items()}


def _port_totals(c, grid, mode, xyzz: bool):
    st = c["st"]
    pts = {k: c["t"][k] for k in KEYS} if xyzz else st["pts"]
    tail1, colend, flag = msm3.accum_plain(c["tf"], grid, c["sorted_d"], pts, mode, K4_NB,
                                           st["src"], None if xyzz else st["signs"])
    assert not flag.any()
    return msm3._bucket_totals(c["tf"], c["sorted_d"], tail1, colend, grid, K4_NB)


def test_accum_plain_matches_accum_xla(k4_case):
    """Plain K4 (level-1 tail table and carries) with affine input, in fast
    and complete mode, then the suffix pass over the 128 carries: per-bucket
    totals equal msm3._accum_xla followed by msm3._bucket_totals, bit for
    bit (no add is degenerate, so fast equals complete, unflagged)."""
    grid = k4_case["st"]["grid"]
    assert grid == (32, 128)
    want = _jax_totals(k4_case, grid, False)
    for mode in ("fast", "complete"):
        got = _port_totals(k4_case, grid, mode, False)
        for k in KEYS:
            assert np.array_equal(want[k], got[k].numpy()), (mode, k)


def test_accum_level2_matches_bucket_totals(k4_case):
    """XYZZ input in complete mode on a (4, 1024) grid: the level-1 tails,
    the level-2 pass over the 1,024 carries (K4 again, XYZZ complete, its own
    tail table) and the suffix pass over its 128 carries give per-bucket
    totals equal to the JAX package's composition, bit for bit."""
    grid = (4, 1024)
    want = _jax_totals(k4_case, grid, True)
    got = _port_totals(k4_case, grid, "complete", True)
    for k in KEYS:
        assert np.array_equal(want[k], got[k].numpy()), k


def test_accum_tail_table_rows(k4_case):
    """The level-1 tail table has a nonzero row exactly for the buckets
    whose run ends inside a column, holding that run's sum of its cells'
    points (read through the permutation, y negated for negative digits);
    a repeated point in a run flags its column in fast mode only."""
    c = k4_case
    tf, sorted_d, st = c["tf"], c["sorted_d"], c["st"]
    R, C = grid = (4, 1024)
    tail1, _, _ = msm3.accum(tf, grid, sorted_d, st["pts"], "complete", K4_NB,
                             st["src"], st["signs"])
    sd = sorted_d.numpy()
    ends = np.flatnonzero(np.append(sd[1:] != sd[:-1], True))  # last cell of each run
    mid = [e for e in ends if e % R < R - 1 and sd[e] > 0]
    got_rows = np.flatnonzero(tail1["zz"].numpy().any(axis=1))
    assert got_rows.tolist() == sorted(int(sd[e]) - 1 for e in mid) and len(mid) > 10
    # a run that starts and ends inside one column, summed here cell by cell
    heads = np.searchsorted(sd, sd)
    e = next(e for e in mid if heads[e] < e and heads[e] // R == e // R)
    start = heads[e]
    pts, src, signs = st["pts"], st["src"], st["signs"]
    acc = None
    for p in range(start, e + 1):
        r = int(src[p])
        y = pts["yneg"][r] if signs[r] < 0 else pts["y"][r]
        one = tf.one_mont(y[None])
        q = {"x": pts["x"][r][None], "y": y[None], "zz": one, "zzz": one}
        acc = q if acc is None else xyzz_add_port(tf, acc, q)
    for k in KEYS:
        assert torch.equal(acc[k][0], tail1[k][sd[e] - 1]), k
    # the same cell twice in that run: P + P in fast mode
    dup = src.clone()
    dup[start + 1] = dup[start]
    col = start // R
    _, _, fflag = msm3.accum(tf, grid, sorted_d, pts, "fast", K4_NB, dup, signs)
    _, _, cflag = msm3.accum(tf, grid, sorted_d, pts, "complete", K4_NB, dup, signs)
    assert fflag.nonzero().flatten().tolist() == [col] and not cflag.any()


def _affine(tbl):
    """Standard-form XYZZ (1, 16) rows -> affine (x, y), None for identity."""
    v = {k: int.from_bytes(np.asarray(a).reshape(-1).astype("<u2").tobytes(), "little")
         for k, a in tbl.items()}
    if v["zz"] == 0:
        return None
    f = JCURVE.base
    return (f.mul(v["x"], f.inv(v["zz"])), f.mul(v["y"], f.inv(v["zzz"])))


def test_bucket_reduce_plain_matches_weighted_reduce(case):
    """Plain K5 with its combine (nb = 512: two groups of 256) equals
    msm3._weighted_reduce_xla in affine form (the addition orders differ);
    the one-group case runs inside every MSM test."""
    nb = 512
    jf, tf = JField(JCURVE.base), TField(TCURVE.base)
    jfx, jfy, _ = jmsm3._fixed3_host(case["jdb"], C9, 512)
    one = jnp.broadcast_to(jnp.asarray(jf.r_limbs), (nb, 16))
    tbl = jpoints.xyzz_double(jf, {"x": jfx[:nb], "y": jfy[:nb], "zz": one, "zzz": one})
    tbl = {k: np.array(v) for k, v in tbl.items()}
    for k in ("zz", "zzz"):
        tbl[k][3::7] = 0
    want = jmsm3._weighted_reduce_xla(jf, {k: jnp.asarray(v) for k, v in tbl.items()})
    got = msm2._bucket_reduce(tf, {k: torch.from_numpy(v.astype(np.int32)) for k, v in tbl.items()})
    want_std = {k: np.asarray(jf.from_mont(v.T)) for k, v in want.items()}
    got_std = {k: tf.from_mont(v).numpy() for k, v in got.items()}
    assert _affine(got_std) == _affine(want_std)
    assert _affine(got_std) is not None


@pytest.mark.parametrize("bits", [1, 16])
def test_max_bits(case, bits):
    n = 300
    rng = np.random.default_rng(40 + bits)
    scalars = [int(x) for x in rng.integers(0, 1 << bits, n)]
    got = msm3.msm_device3(scalars, device_bases=case["tdb"], window=C9, max_bits=bits)
    assert _xy(got) == _xy(host_msm(scalars, case["bases"][:n]))


def test_edge_scalars(case):
    order = JCURVE.scalar.p
    scalars = ([0, 1, order - 1, 2, order - 2] * 100)[:500]
    got = msm3.msm_device3(scalars, device_bases=case["tdb"], window=C9)
    assert _xy(got) == _xy(host_msm(scalars, case["bases"]))


def test_repeated_bases_degenerate_retry(monkeypatch):
    n = 520
    b = _bases(8)
    bases = (b * (n // 8 + 1))[:n]
    rng = np.random.default_rng(3)
    scalars = [int(x) for x in rng.integers(0, 1 << 16, n)]
    tdb = _port_db(JDeviceBases2(JCURVE, bases), 1024)
    modes = []
    real = msm3.accum

    def spy(tf, grid, digits, pts, mode, nb, src=None, signs=None):
        out = real(tf, grid, digits, pts, mode, nb, src, signs)
        modes.append((mode, "zz" in pts, bool(out[2].any())))
        return out

    monkeypatch.setattr(msm3, "accum", spy)
    got = msm3.msm_device3(scalars, device_bases=tdb, window=C9)
    assert _xy(got) == _xy(host_msm(scalars, bases))
    assert ("fast", False, True) in modes  # the fast pass flagged P = +-Q
    assert ("complete", False, False) in modes  # and level 1 reran complete


@pytest.mark.parametrize("r_min", [32, 8])
def test_bucket_totals_branches(case, monkeypatch, r_min):
    """C <= 256 (suffix pass) and C > 256 (level-2 accumulate) branches."""
    monkeypatch.setattr(msm3, "_R_MIN", r_min)
    R, C = msm3._grid_shape(29 * 512)
    assert (C <= 256) == (r_min == 32) and R * C == 29 * 512
    got = msm3.msm_device3_mont(_mont(case["scalars"]), case["tdb"], window=C9)
    assert _xy(got) == case["want"]


def test_chunking(case, monkeypatch):
    monkeypatch.setattr(msm3, "_CHUNK_MAX", 256)
    n = len(case["scalars"])
    for a in range(0, n, 256):
        b = min(a + 256, n)
        jfx, jfy, jfinf = jmsm3._fixed3_host(jmsm3._db_slice(case["jdb"], a, b), C9, 512)
        interop.set_fixed(msm3._db_slice(case["tdb"], a, b), C9, 512,
                          np.asarray(jfx), np.asarray(jfy), np.asarray(jfinf))
    got = msm3.msm_device3_mont(_mont(case["scalars"]), case["tdb"], window=C9)
    assert _xy(got) == case["want"]


def test_batch_equals_sequential(case):
    s = case["scalars"]
    other = s[::-1]
    batch = msm3.msm_device3_mont_batch([_mont(s), _mont(other)], case["tdb"], window=C9)
    seq = msm3.msm_device3_mont(_mont(other), case["tdb"], window=C9)
    # case["want"] is also the sequential result (test above)
    assert [_xy(p) for p in batch] == [case["want"], _xy(seq)]
    assert _xy(seq) == _xy(host_msm(other, case["bases"]))
