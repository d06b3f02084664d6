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


def _grid_inputs(case, R, C):
    rng = np.random.default_rng(4)
    d = np.sort(rng.integers(0, 24, R * C)).astype(np.int32)
    d[:7] = 0
    jfx, jfy, _ = jmsm3._fixed3_host(case["jdb"], C9, 512)
    idx = rng.permutation(R * C)
    cm = np.arange(R * C).reshape(C, R).T  # cell (i, j) <- sorted j*R + i
    px = np.asarray(jfx)[idx][cm]
    py = np.asarray(jfy)[idx][cm]
    return d[cm], px, py


def test_accum_plain_matches_accum_xla(case):
    """Plain K4 == msm3._accum_xla (complete mode) bitwise, affine and XYZZ
    input; fast mode equals complete mode on distinct bases, unflagged."""
    R, C = 8, 64
    d_cm, px, py = _grid_inputs(case, R, C)
    jf, tf = JField(JCURVE.base), TField(TCURVE.base)
    jfl, jce, _ = jmsm3._accum_xla(jf, jnp.asarray(d_cm), jnp.asarray(px), jnp.asarray(py), "complete")
    pts = {"x": torch.from_numpy(px.astype(np.int32)), "y": torch.from_numpy(py.astype(np.int32))}
    dg = torch.from_numpy(d_cm)
    fl, ce, _ = msm3.accum_plain(tf, dg, pts, "complete")
    for k in KEYS:
        assert np.array_equal(np.asarray(jfl[k]).astype(np.int32), fl[k].numpy()), k
        assert np.array_equal(np.asarray(jce[k]).astype(np.int32), ce[k].numpy()), k
    # fast mode encodes inert (digit-0) runs differently, so compare it on a
    # grid without digit 0, where it equals complete mode bit for bit
    dg1 = dg + 1
    fl, ce, _ = msm3.accum_plain(tf, dg1, pts, "complete")
    ffl, fce, flag = msm3.accum_plain(tf, dg1, pts, "fast")
    for k in KEYS:
        assert torch.equal(fl[k], ffl[k]) and torch.equal(ce[k], fce[k]), k
    assert not flag.any()
    # XYZZ input (the level-2 form): doubled points, a few identities
    dbl = jpoints.xyzz_double(jf, {
        "x": jnp.asarray(px), "y": jnp.asarray(py),
        "zz": jnp.broadcast_to(jnp.asarray(jf.r_limbs), px.shape),
        "zzz": jnp.broadcast_to(jnp.asarray(jf.r_limbs), px.shape),
    })
    dbl = {k: np.array(v) for k, v in dbl.items()}
    dbl["zz"][0, :5] = 0
    jfl, jce, _ = jmsm3._accum_xla(
        jf, jnp.asarray(d_cm), *(jnp.asarray(dbl[k]) for k in ("x", "y")),
        "complete", jnp.asarray(dbl["zz"]), jnp.asarray(dbl["zzz"]),
    )
    fl, ce, _ = msm3.accum_plain(
        tf, dg, {k: torch.from_numpy(v.astype(np.int32)) for k, v in dbl.items()},
        "complete",
    )
    for k in KEYS:
        assert np.array_equal(np.asarray(jfl[k]).astype(np.int32), fl[k].numpy()), k
        assert np.array_equal(np.asarray(jce[k]).astype(np.int32), ce[k].numpy()), k


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

    def spy(tf, d_grid, pts, mode):
        out = real(tf, d_grid, pts, mode)
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
