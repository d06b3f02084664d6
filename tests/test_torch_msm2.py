"""The port's int-scalar MSM (``nova_tpu_torch.ops.msm2``: digits, masks,
stage plan, the plain stage B6 and ``msm_device2``) against
``nova_tpu.ops.msm2`` on CPU and the host Pippenger.

Tolerances: digits, masks and plans are exact. The plain stage in complete
mode equals the JAX package's ``_stage`` (its XLA path) bit for bit; the
fast modes are held to it bit for bit where no add is degenerate and by the
flag where one is. Window sums and MSM results are compared as affine
points, because the two packages reduce buckets in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_tpu.curves.msm_host import msm as host_msm
from nova_tpu.curves.spec import pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.ops import msm2 as jmsm2
from nova_tpu.ops import msm3 as jmsm3
from nova_tpu.ops.msm2 import DeviceBases2 as JDeviceBases2
from nova_tpu.provider.pedersen import CommitmentEngine as JCE

from nova_tpu_torch import interop
from nova_tpu_torch.curves.spec import pallas as TCURVE
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm2, msm3

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

KEYS = ("x", "y", "zz", "zzz")
C8 = 8


@pytest.fixture(scope="module")
def case():
    """512 hashed-to-curve bases (distinct, unrelated), marshalled by both
    packages; the port gets the reference's window-8 precompute."""
    jck = JCE.setup(JCURVE, b"port-msm2-test", 512)
    bases = list(jck.ck[:512])
    jdb = JDeviceBases2(JCURVE, bases)
    return {"bases": bases, "jdb": jdb, "tdb": _port_db(jdb, C8, 512)}


def _port_db(jdb, c, n_pad):
    tdb = interop.device_bases2(
        TCURVE, np.asarray(jdb.x), np.asarray(jdb.y), np.asarray(jdb.inf), "cpu"
    )
    fx, fy, finf = jmsm3._fixed3_host(jdb, c, n_pad)
    interop.set_fixed(tdb, c, n_pad, np.asarray(fx), np.asarray(fy), np.asarray(finf))
    return tdb


def _xy(p):
    return (p.x, p.y, p.infinity)


def _scalars(seed, n, bits=None):
    rng = np.random.default_rng(seed)
    if bits is not None:
        return [int(x) for x in rng.integers(0, 1 << bits, n)]
    return [int.from_bytes(rng.bytes(32), "little") % JCURVE.scalar.p for _ in range(n)]


def _runs(seed, n, nb):
    """Sorted |digits| in [0, nb] with runs of every length, and ranks."""
    rng = np.random.default_rng(seed)
    ds = np.sort(rng.integers(0, nb + 1, n)).astype(np.int32)
    heads = np.concatenate([[True], ds[1:] != ds[:-1]])
    idx = np.arange(n, dtype=np.int32)
    rank = idx - np.maximum.accumulate(np.where(heads, idx, 0)).astype(np.int32)
    return ds, rank


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_signed_digits_match():
    p = JCURVE.scalar.p
    vals = [0, 1, p - 1, (1 << 255) + 12345, (1 << 256) - 1] + _scalars(2, 59)
    limbs = jmsm2._scalar_limbs(vals, 64)
    assert np.array_equal(limbs.astype(np.int32), msm2._scalar_limbs(vals, 64))
    for c in (8, 12, 14, 16):
        W = (255 + c - 1) // c + 1
        want = np.asarray(jmsm2.signed_digits_device(jnp.asarray(limbs), c, W))
        got = msm2.signed_digits_device(torch.from_numpy(limbs.astype(np.int32)), c, W)
        assert np.array_equal(want, got.numpy()), c


@pytest.mark.parametrize("n,nb", [(512, 128), (2048, 64), (20 * 512, 2048)])
def test_round_masks_and_plan_match(n, nb):
    ds, rank = _runs(n, n, nb)
    for rounds in (1, 3, 4):
        want = np.asarray(jmsm2._round_masks(jnp.asarray(ds), jnp.asarray(rank), rounds))
        got = msm2._round_masks(_t(ds), _t(rank), rounds)
        assert np.array_equal(want.astype(np.int32), got.numpy())
    assert msm2._plan(n, nb) == jmsm2._plan(n, nb)


@pytest.mark.parametrize("seed,n,nb", [(21, 4096, 8), (22, 4096, 600), (23, 1, 4)])
def test_segment_rank_matches_cummax(seed, n, nb):
    """_window_sum's ranks by binary search equal the JAX _window_sum's
    idx - cummax(where(heads, idx, 0)) over random sorted runs."""
    ds, want = _runs(seed, n, nb)
    got = msm2._segment_rank(_t(ds))
    idx = torch.arange(n)
    heads = torch.cat([torch.ones(1, dtype=torch.bool), _t(ds)[1:] != _t(ds)[:-1]])
    cm = idx - torch.cummax(torch.where(heads, idx, 0), dim=0).values
    assert torch.equal(got, cm) and np.array_equal(got.numpy(), want)


def _stage_inputs(case, n, nb, rounds, seed):
    ds, rank = _runs(seed, n, nb)
    masks = jmsm2._round_masks(jnp.asarray(ds), jnp.asarray(rank), rounds)
    jdb = case["jdb"]
    x, y = np.asarray(jdb.x)[:n], np.asarray(jdb.y)[:n]
    return ds, np.asarray(masks), x, y


def _jax_stage(rounds, masks, pts, live=None):
    jf = JField(JCURVE.base)
    out, _ = jmsm2._stage(
        jf, rounds, jnp.asarray(masks), {k: jnp.asarray(v) for k, v in pts.items()},
        512, "complete", live=None if live is None else jnp.asarray(live),
    )
    return {k: np.asarray(v).astype(np.int32) for k, v in out.items()}


def _xyzz_input(x, y):
    """Doubled bases with a few identities: an XYZZ stage input."""
    jf = JField(JCURVE.base)
    one = jnp.broadcast_to(jnp.asarray(jf.r_limbs, jnp.uint32), x.shape)
    d = jmsm2._xyzz_double_limbs(
        jmsm2._limb_ops(*jmsm2._field_key(jf)[1:]),
        tuple([jnp.asarray(v)[:, i] for i in range(16)] for v in (x, y, one, one)),
    )
    pts = {k: np.stack([np.asarray(l) for l in c], axis=1) for k, c in zip(KEYS, d)}
    for k in ("zz", "zzz"):
        pts[k][5::37] = 0
    return pts


def test_stage_plain_complete_matches_reference_bitwise(case):
    n, rounds = 256, 3
    ds, masks, x, y = _stage_inputs(case, n, 24, rounds, 5)
    tf = TField(TCURVE.base)
    live = ds != 0
    want = _jax_stage(rounds, masks, {"x": x, "y": y}, live)
    got, flag = msm2.stage(
        tf, rounds, _t(masks), {"x": _t(x), "y": _t(y)}, "complete", torch.from_numpy(live)
    )
    for k in KEYS:
        assert np.array_equal(want[k], got[k].numpy()), k
    assert not flag
    pts = _xyzz_input(x, y)
    want = _jax_stage(rounds, masks, pts)
    got, _ = msm2.stage(tf, rounds, _t(masks), {k: _t(v) for k, v in pts.items()}, "complete")
    for k in KEYS:
        assert np.array_equal(want[k], got[k].numpy()), k


def test_stage_plain_fast_modes(case):
    """fast0 (affine input) and fast (XYZZ input) equal complete mode bit
    for bit on distinct bases, unflagged; a repeated point sets the flag."""
    n, rounds = 512, 4
    tf = TField(TCURVE.base)
    ds, masks, x, y = _stage_inputs(case, n, 40, rounds, 7)
    live = torch.from_numpy(ds != 0)
    aff = {"x": _t(x), "y": _t(y)}
    ref, _ = msm2.stage_plain(tf, rounds, _t(masks), aff, "complete", live)
    got, flag = msm2.stage_plain(tf, rounds, _t(masks), aff, "fast0", live)
    assert all(torch.equal(ref[k], got[k]) for k in KEYS) and not flag
    pts = {k: _t(v) for k, v in _xyzz_input(x, y).items()}
    ref, _ = msm2.stage_plain(tf, rounds, _t(masks), pts, "complete")
    got, flag = msm2.stage_plain(tf, rounds, _t(masks), pts, "fast")
    assert all(torch.equal(ref[k], got[k]) for k in KEYS) and not flag
    # lane 1 repeats lane 0's point in one run: its round-0 add is P + P
    run = np.flatnonzero(masks[0])[0]
    dup = {k: v.clone() for k, v in aff.items()}
    for k in dup:
        dup[k][run + 1] = dup[k][run]
    for mode in ("fast0", "fast"):
        _, flag = msm2.stage_plain(tf, rounds, _t(masks), dup, mode, live)
        assert flag, mode
    # blocking with a halo gives the one-pass result
    one, _ = msm2.stage_plain(tf, rounds, _t(masks), pts, "fast")
    blk, _ = msm2.stage_plain(tf, rounds, _t(masks), pts, "fast", block=100)
    assert all(torch.equal(one[k], blk[k]) for k in KEYS)


def _affine_std(tf, rows, curve=JCURVE):
    v = {k: int.from_bytes(np.asarray(a).reshape(-1).astype("<u2").tobytes(), "little")
         for k, a in rows.items()}
    if v["zz"] == 0:
        return None
    f = curve.base
    return (f.mul(v["x"], f.inv(v["zz"])), f.mul(v["y"], f.inv(v["zzz"])))


def test_window_sum_matches_reference(case):
    """One small window space through both packages' _window_sum: the
    weighted bucket sum agrees as an affine point."""
    n, c = 64, 3
    nb = 1 << (c - 1)
    rng = np.random.default_rng(9)
    absd = rng.integers(0, nb + 1, n).astype(np.int32)
    jdb = case["jdb"]
    x, y = np.asarray(jdb.x)[:n], np.asarray(jdb.y)[:n]
    jf, tf = JField(JCURVE.base), TField(TCURVE.base)
    ws, _ = jmsm2._window_sum(jf, jnp.asarray(absd), jnp.asarray(x), jnp.asarray(y), 512, nb)
    want = {k: np.asarray(jf.from_mont(v.T)) for k, v in ws.items()}
    got, flag = msm2._window_sum(tf, _t(absd), _t(x), _t(y), nb)
    assert not flag
    got = {k: tf.from_mont(v).numpy() for k, v in got.items()}
    assert _affine_std(tf, got) == _affine_std(tf, want) is not None


def test_msm_device2_fixed_matches_host_and_msm3(case):
    n = 500
    s = _scalars(11, n)
    want = _xy(host_msm(s, case["bases"][:n]))
    got = msm2.msm_device2(s, device_bases=case["tdb"], window=C8)
    assert _xy(got) == want
    got3 = msm3.msm_device3(s, device_bases=case["tdb"], window=C8)
    assert _xy(got3) == want


def test_msm_device2_general_path(case):
    n = 100
    s = _scalars(12, n)
    got = msm2.msm_device2(s, bases=case["bases"][:n], window=C8, device="cpu")
    assert _xy(got) == _xy(host_msm(s, case["bases"][:n]))


def test_msm_device2_repeated_bases_take_complete_rerun(case, monkeypatch):
    """Eight bases repeated: equal (base, digit) pairs meet in a digit run,
    the fast pass flags P = +-Q, and the complete rerun gives the exact
    result."""
    n = 400
    bases = (case["bases"][:8] * (n // 8))[:n]
    s = _scalars(13, n, bits=16)
    tdb = _port_db(JDeviceBases2(JCURVE, bases), C8, 512)
    modes = []
    real = msm2._msm2_fixed_program

    def spy(tf, c, limbs, fixed, mode):
        out = real(tf, c, limbs, fixed, mode)
        modes.append((mode, bool(out[1])))
        return out

    monkeypatch.setattr(msm2, "_msm2_fixed_program", spy)
    got = msm2.msm_device2(s, device_bases=tdb, window=C8)
    assert _xy(got) == _xy(host_msm(s, bases))
    assert modes == [("fast0", True), ("complete", False)]


def test_msm_device2_window_rule():
    assert [msm2._window_for(1 << k) for k in (9, 13, 14, 17, 18)] == [12, 12, 14, 14, 16]
    with pytest.raises(ValueError):
        msm2.msm_device2([])
