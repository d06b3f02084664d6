"""msm1, the port's sorted-bucket Pippenger (``nova_tpu_torch.ops.msm``: K2
combine rounds, K3 Horner doublings, K1 marshalling; plain versions on CPU
tensors) against ``nova_tpu.ops.msm`` and the JAX package's host
Pippenger, and the forward step of ``graft_entry.entry``.

Tolerance: exact (limb and digit arrays equal element for element, MSM
results equal as affine points)."""

import random

import numpy as np
import pytest
import torch

from nova_tpu.curves.msm_host import msm as jhost_msm
from nova_tpu.curves.spec import AffinePoint as JAffine, pallas as JPALLAS
from nova_tpu.ops import msm as jmsm

from nova_tpu_torch import graft_entry
from nova_tpu_torch.curves.spec import AffinePoint, pallas
from nova_tpu_torch.ops import msm
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

N = 64


def _chain(n, start=1):
    """start*G, 2*start*G, 4*start*G, ... on Pallas."""
    bases, acc = [], AffinePoint.generator(pallas).mul(start)
    for _ in range(n):
        bases.append(acc)
        acc = acc.double()
    return bases


def _jhost(scalars, bases):
    """The JAX package's host Pippenger on the port's points."""
    pts = [JAffine.identity(JPALLAS) if b.infinity else JAffine(JPALLAS, b.x, b.y)
           for b in bases]
    r = jhost_msm(list(scalars), pts)
    return (r.x, r.y, r.infinity)


def _xy(p):
    return (p.x, p.y, p.infinity)


def test_limbs_and_digits_match_reference():
    rng = np.random.default_rng(1)
    p = pallas.scalar.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(40)]
    scalars += [0, 1, p - 1, (1 << 254) - 1]
    got = msm.scalars_to_limbs16(scalars)
    want = jmsm.scalars_to_limbs16(scalars)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for c in (3, 8, 13, 16):
        for nw in (1, (255 + c - 1) // c):
            assert np.array_equal(msm.digits_for_windows(got, c, nw),
                                  jmsm.digits_for_windows(want, c, nw)), (c, nw)
    assert [msm._limbs16_to_int(torch.from_numpy(r.astype(np.int32))) for r in got] == scalars
    assert [jmsm._limbs16_to_int(r) for r in want] == scalars


def test_device_bases_match_reference():
    bases = _chain(8) + [AffinePoint.identity(pallas)]
    db = msm.DeviceBases(pallas, bases, device="cpu")
    jdb = jmsm.DeviceBases(JPALLAS, [JAffine.identity(JPALLAS) if b.infinity
                                     else JAffine(JPALLAS, b.x, b.y) for b in bases])
    for a, b in ((db.x, jdb.x), (db.y, jdb.y)):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    assert db.inf.tolist() == np.asarray(jdb.inf).tolist() and db.n == jdb.n == 9


def test_chunk_size_divides_and_stays_a_power_of_two():
    """The chunk arithmetic of both packages' msm_device: a power of two
    that divides n, never 1 for a budget that allows more (a non-power-of-two
    budget / W once halved down to chunk = 1)."""
    for W in (1, 3, 8, 17, 20, 32, 33):
        for log_n in (1, 8, 14, 18, 20, 21):
            n = 1 << log_n
            ch = msm._chunk_size(n, W)
            assert ch & (ch - 1) == 0 and n % ch == 0
            cap = min(msm._WINDOW_POINT_BUDGET // W, n)
            assert ch == 1 << (cap.bit_length() - 1), (W, n, ch)


def _scalars(kind, n, seed):
    rng = random.Random(seed)
    if kind == "full":
        return [rng.randrange(pallas.scalar.p) for _ in range(n)]
    if kind == "small":
        return [rng.randrange(1 << 10) for _ in range(n)]
    return [rng.randrange(2) for _ in range(n)]  # single-bit


@pytest.mark.parametrize("kind", ["full", "small", "bits"])
def test_msm_device_matches_host(kind):
    """msm_device (the msm_small window count, the host bincount's rounds)
    against the host Pippenger, with an infinity base among the bases and
    a non-power-of-two length."""
    bases = _chain(N - 1) + [AffinePoint.identity(pallas)]
    bases[5] = AffinePoint.identity(pallas)
    scalars = _scalars(kind, N - 3, 7)
    db = msm.DeviceBases(pallas, bases, device="cpu")
    got = msm.msm_device(scalars, device_bases=db)
    assert _xy(got) == _jhost(scalars, bases[: len(scalars)])


def test_msm_device_tables_merge_across_chunks(monkeypatch):
    """A budget of 256 window-points makes 8-point chunks at c = 8 (32
    windows): every chunk's bucket tables add into the running tables (K2),
    and repeated digits need the combine rounds."""
    monkeypatch.setattr(msm, "_WINDOW_POINT_BUDGET", 256)
    rng = random.Random(9)
    bases = _chain(N)
    scalars = [rng.choice([3, 5, (1 << 200) + 7, pallas.scalar.p - 1]) for _ in range(N)]
    got = msm.msm_device(scalars, bases=bases, device_bases=msm.DeviceBases(
        pallas, bases, device="cpu"), window=8)
    assert _xy(got) == _jhost(scalars, bases)


def test_msm_device_on_commitment_key_generators():
    """msm_device over a Pedersen key's generators marshalled with fewer
    bases than the padded length (the pad lanes are identities)."""
    ck = TCE.setup(pallas, b"port-msm1-key", 40, device="cpu", workers=1)
    db = msm.DeviceBases(pallas, ck.ck[:33], device="cpu")
    assert db.n == 33 and db.x.device.type == "cpu"
    scalars = _scalars("full", 33, 3)
    assert _xy(msm.msm_device(scalars, device_bases=db)) == _jhost(scalars, ck.ck[:33])


def test_entry_forward_step_matches_host():
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].shape == (32, graft_entry.ENTRY_POINTS)
    x, y, zz, zzz = fn(*args)
    f = pallas.base
    got = (f.mul(msm._limbs16_to_int(x), f.inv(msm._limbs16_to_int(zz))),
           f.mul(msm._limbs16_to_int(y), f.inv(msm._limbs16_to_int(zzz))), False)
    scalars, bases = graft_entry.entry_inputs()
    assert got == _jhost(scalars, bases)
