"""TField (the port's tensor field engine, plain versions on CPU) against
JField on CPU, which takes its XLA branch. Bitwise, including edge values
and non-canonical limbs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_tpu.fields import spec as jspec
from nova_tpu.fields.jfield import JField

from nova_tpu_torch.fields import spec as tspec
from nova_tpu_torch.fields.tfield import TField

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

N = 64
FIELDS = sorted(tspec.ALL_FIELDS)


def _vals(p, rng, extra=()):
    edge = [0, 1, 2, p - 1, p - 2, (p + 1) // 2, *extra]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N - len(edge))]
    return edge + rand


def _pair(name, seed, extra=()):
    js, ts = jspec.ALL_FIELDS[name], tspec.ALL_FIELDS[name]
    jf, tf = JField(js), TField(ts)
    rng = np.random.default_rng(seed)
    a = jf.pack(_vals(js.p, rng, extra))
    b = jf.pack(_vals(js.p, rng)[::-1])
    return jf, tf, a, b


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
def test_binary_ops_bitwise(name):
    # (2^256 - 1) is not canonical: mont_mul must still agree bit for bit
    jf, tf, a, b = _pair(name, 1, extra=((1 << 256) - 1,))
    for op in ("mont_mul", "add", "sub"):
        want = jf.jit(op)(jnp.asarray(a), jnp.asarray(b))
        assert _eq(want, getattr(tf, op)(_t(a), _t(b))), op


@pytest.mark.parametrize("name", ["pallas_base", "secp_base"])
def test_unary_ops_bitwise(name):
    jf, tf, a, _ = _pair(name, 2)
    A, ta = jnp.asarray(a), _t(a)
    for op in ("neg", "double", "square", "to_mont", "from_mont"):
        assert _eq(jf.jit(op)(A), getattr(tf, op)(ta)), op
    assert _eq(jf.is_zero(A), tf.is_zero(ta))
    assert _eq(jf.one_mont(A), tf.one_mont(ta))
    assert _eq(jf.const_mont(12345, A), tf.const_mont(12345, ta))
    cond = np.arange(N) % 3 == 0
    assert _eq(
        jf.select(jnp.asarray(cond), A, jnp.zeros_like(A)),
        tf.select(torch.from_numpy(cond), ta, torch.zeros_like(ta)),
    )
    k = np.random.default_rng(3).integers(0, 1 << 15, N)
    assert _eq(
        jf.mul_small(A, jnp.asarray(k.astype(np.uint32))),
        tf.mul_small(ta, torch.from_numpy(k)),
    )
    assert tf.unpack(ta) == jf.unpack(A)
    assert np.array_equal(tf.pack(tf.unpack(ta)), np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("name", ["pallas_base", "secp_base", "bn254_scalar"])
def test_reduce_wide_bitwise(name):
    jf, tf = JField(jspec.ALL_FIELDS[name]), TField(tspec.ALL_FIELDS[name])
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 1 << 30, size=(20, 8), dtype=np.uint32)
    want = jf.reduce_wide([jnp.asarray(cols[i]) for i in range(20)])
    got = tf.reduce_wide([torch.from_numpy(cols[i].astype(np.int64)) for i in range(20)])
    assert _eq(want, got)


@pytest.mark.parametrize("name", ["pallas_scalar", "secp_scalar"])
def test_inversions_bitwise(name):
    jf, tf, a, _ = _pair(name, 5)
    a16 = a[:16]
    assert _eq(jf.jit("batch_inv_tree")(jnp.asarray(a16)), tf.batch_inv_tree(_t(a16)))
    assert _eq(jf.jit("inv")(jnp.asarray(a[3:5])), tf.inv(_t(a[3:5])))
