"""The port's Pedersen engine (device MSM on CPU tensors) against
nova_tpu.provider.pedersen: same generators, same commitments. The
window-shifted precompute is carried across with nova_tpu_torch.interop."""

import numpy as np
import pytest
import torch

from nova_tpu.curves.spec import pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.ops import msm3 as jmsm3
from nova_tpu.ops.fvec import FVec as JFVec
from nova_tpu.provider.pedersen import CommitmentEngine as JCE

from nova_tpu_torch import constants, interop
from nova_tpu_torch.curves.spec import pallas as TCURVE
from nova_tpu_torch.ops import msm3
from nova_tpu_torch.ops.fvec import FVec
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

N = 300
LABEL = b"port-pedersen-test"


def _xy(p):
    return (p.x, p.y, p.infinity)


@pytest.fixture(scope="module")
def keys():
    jck = JCE.setup(JCURVE, LABEL, N)
    tck = TCE.setup(TCURVE, LABEL, N, device="cpu", workers=1)
    jdb, tdb = jck.device_bases2(N), tck.device_bases2(N)
    assert np.array_equal(tdb.x.numpy(), np.asarray(jdb.x).astype(np.int32))
    fx, fy, finf = jmsm3._fixed3_host(jdb, 9, 512)
    interop.set_fixed(tdb, 9, 512, np.asarray(fx), np.asarray(fy), np.asarray(finf))
    return jck, tck


def _scalars(seed, n=N):
    rng = np.random.default_rng(seed)
    p = JCURVE.scalar.p
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def test_setup_generators_match(keys):
    jck, tck = keys
    assert len(tck) == len(jck) == 512
    assert [_xy(g) for g in tck.ck] == [_xy(g) for g in jck.ck]
    assert _xy(tck.h) == _xy(jck.h)


def test_commit_fvec_matches(keys):
    jck, tck = keys
    jv = JFVec.from_ints(JField(JCURVE.scalar), _scalars(1))
    want = JCE.commit(jck, jv, 5)
    got = TCE.commit(tck, interop.fvec(TCURVE.scalar, np.asarray(jv.m), "cpu"), 5)
    assert _xy(got.point) == _xy(want.point)
    assert got.to_transcript_bytes() == want.to_transcript_bytes()


def test_batch_commit_matches(keys, monkeypatch):
    jck, tck = keys
    vals = [_scalars(2), _scalars(3, 200)]
    want = JCE.batch_commit(jck, vals, [0, 7])
    calls = []
    real = msm3.msm_device3_mont_batch
    monkeypatch.setattr(
        msm3, "msm_device3_mont_batch",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )
    got = TCE.batch_commit(
        tck, [FVec.from_ints(TCURVE.scalar, v, device="cpu") for v in vals], [0, 7]
    )
    assert calls, "FVecs must take the batched device MSM"
    assert [_xy(c.point) for c in got] == [_xy(c.point) for c in want]


def test_commit_small_matches(keys, monkeypatch):
    jck, tck = keys
    rng = np.random.default_rng(4)
    vals = [int(x) for x in rng.integers(0, 1 << 16, N)]
    want = JCE.commit_small(jck, vals, 3)
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)
    seen = []
    real = msm3.msm_device3
    monkeypatch.setattr(
        msm3, "msm_device3", lambda *a, **k: seen.append(k["max_bits"]) or real(*a, **k)
    )
    got = TCE.commit_small(tck, vals, 3)
    assert seen == [16]
    assert _xy(got.point) == _xy(want.point)


def test_commit_int_list_host_route_matches(keys):
    jck, tck = keys
    vals = _scalars(6, 40)
    assert _xy(TCE.commit(tck, vals, 9).point) == _xy(JCE.commit(jck, vals, 9).point)
    assert TCE.commit(tck, []).point.is_identity()
