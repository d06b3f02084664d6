"""Port host math (nova_tpu_torch.fields/curves spec, msm_host, keccak,
hash-to-curve, from_label) against the JAX package's, on all six curves.
Every comparison is exact."""

import numpy as np
import pytest

from nova_tpu.curves import spec as jcurves
from nova_tpu.curves.msm_host import msm as jmsm
from nova_tpu.provider import pedersen as jped
from nova_tpu.provider.keccak import Shake256 as JShake

from nova_tpu_torch.curves import spec as tcurves
from nova_tpu_torch.curves.msm_host import msm as tmsm
from nova_tpu_torch.provider import pedersen as tped
from nova_tpu_torch.provider.keccak import Shake256 as TShake

NAMES = sorted(tcurves.ALL_CURVES)


def _xy(p):
    return (p.x, p.y, p.infinity)


def _rand_scalar(rng, order):
    return int.from_bytes(rng.bytes(32), "little") % order


@pytest.mark.parametrize("name", NAMES)
def test_spec_constants(name):
    tc, jc = tcurves.ALL_CURVES[name], jcurves.ALL_CURVES[name]
    assert (tc.b, tc.gen_x, tc.gen_y) == (jc.b, jc.gen_x, jc.gen_y)
    for tf, jf in ((tc.base, jc.base), (tc.scalar, jc.scalar)):
        assert tf.name == jf.name
        for attr in ("p", "num_bits", "r", "r2", "r3", "n0inv", "p_limbs"):
            assert getattr(tf, attr) == getattr(jf, attr), attr


@pytest.mark.parametrize("name", NAMES)
def test_affine_point_ops(name):
    tc, jc = tcurves.ALL_CURVES[name], jcurves.ALL_CURVES[name]
    rng = np.random.default_rng(sum(name.encode()))
    order = tc.scalar.p
    tg, jg = tcurves.AffinePoint.generator(tc), jcurves.AffinePoint.generator(jc)
    for _ in range(3):
        k1, k2 = _rand_scalar(rng, order), _rand_scalar(rng, order)
        tp, jp = tg.mul(k1), jg.mul(k1)
        tq, jq = tg.mul(k2), jg.mul(k2)
        assert _xy(tp) == _xy(jp)
        assert _xy(tp.add(tq)) == _xy(jp.add(jq))
        assert _xy(tp.double()) == _xy(jp.double())
        assert _xy(tp.sub(tq)) == _xy(jp.sub(jq))
        assert tp.to_transcript_bytes() == jp.to_transcript_bytes()
    assert tp.add(tp.neg()).is_identity()
    assert _xy(tp.add(tp)) == _xy(jp.double())
    assert tg.mul(order).is_identity()


def test_shake256_matches():
    for msg in (b"", b"abc", b"x" * 300):
        t = TShake().update(msg).finalize_xof().read(333)
        j = JShake().update(msg).finalize_xof().read(333)
        assert t == j


@pytest.mark.parametrize("name", NAMES)
def test_from_label_matches(name):
    tg = tped.from_label(tcurves.ALL_CURVES[name], b"port-test", 3)
    jg = jped.from_label(jcurves.ALL_CURVES[name], b"port-test", 3)
    assert [_xy(p) for p in tg] == [_xy(p) for p in jg]


def test_from_label_process_pool_same_list():
    curve = tcurves.pallas
    serial = tped.from_label(curve, b"pool", 12)
    pooled = tped.from_label(curve, b"pool", 12, workers=2)
    assert [_xy(p) for p in pooled] == [_xy(p) for p in serial]


@pytest.mark.parametrize("name", NAMES)
def test_host_msm_matches(name):
    tc, jc = tcurves.ALL_CURVES[name], jcurves.ALL_CURVES[name]
    rng = np.random.default_rng(5)
    n = 20
    ks = [_rand_scalar(rng, tc.scalar.p) for _ in range(n)]
    scal = [_rand_scalar(rng, tc.scalar.p) for _ in range(n)]
    scal[3] = 0
    tb = [tcurves.AffinePoint.generator(tc).mul(k) for k in ks]
    jb = [jcurves.AffinePoint.generator(jc).mul(k) for k in ks]
    assert _xy(tmsm(scal, tb)) == _xy(jmsm(scal, jb))
    assert _xy(tmsm(scal[:5], tb[:5])) == _xy(jmsm(scal[:5], jb[:5]))
