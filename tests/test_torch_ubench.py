"""The port's field microbenchmark kernels P1/P2
(``nova_tpu_torch.perf.ubench_field``) against the JAX bodies of
``perf/ubench_field.py`` on CPU.

The JAX module parses ``sys.argv[1:3]`` when imported, so it is imported
with argv ["ubench_field.py", "8", "2"] (N = 256, ITERS = 2; its bodies
read the module-global ITERS when traced). Its jitted chains are not
interpretable on the CPU, so the bodies ``mont16_kernel`` / ``mont8_kernel``
run in this file's own ``pallas_call`` in interpret mode on one block. A
pure-Python integer model of one product is a second oracle. Tolerance:
exact (bit for bit)."""

import importlib.util
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nova_tpu_torch.perf import ubench_field as tub

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ITERS = 256, 2


@pytest.fixture(scope="module")
def jub():
    spec = importlib.util.spec_from_file_location(
        "_jax_ubench_field", os.path.join(ROOT, "perf", "ubench_field.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["ubench_field.py", "8", "2"]):
        spec.loader.exec_module(mod)
    assert (mod.N, mod.ITERS) == (N, ITERS)
    return mod


def _interpret(body, a, b):
    """The TPU body on one block, in Pallas interpret mode."""
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(a.shape, jnp.uint32), grid=(1,),
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))


def _operands(seed):
    rng = np.random.default_rng(seed)
    a16 = rng.integers(0, 1 << 16, (16, N), dtype=np.int64).astype(np.uint32)
    b16 = rng.integers(1, 1 << 16, (16, N), dtype=np.int64).astype(np.uint32)
    a8 = rng.integers(0, 256, (32, N), dtype=np.int64).astype(np.uint32)
    b8 = rng.integers(0, 256, (32, N), dtype=np.int64).astype(np.uint32)
    # edge columns: all-zero, all-max limbs (values far above p)
    for a, b, top in ((a16, b16, 0xFFFF), (a8, b8, 0xFF)):
        a[:, 0] = 0
        a[:, 1] = top
        b[:, 1] = top
        b[:, 2] = top
    return a16, b16, a8, b8


_A16, _B16, _A8, _B8 = _operands(41)


def _int_model_step(a_col, b_col, bits):
    """One product of the TPU body as Python ints: the schoolbook columns
    and the limb-serial reduction, no final subtraction, top carry dropped."""
    nl = 256 // bits
    mask = (1 << bits) - 1
    p = tub._limbs(bits)
    n0 = tub._n0(bits)
    cols = [0] * (2 * nl + 1)
    for i in range(nl):
        for j in range(nl):
            cols[i + j] += a_col[i] * b_col[j]
    carry = 0
    for i in range(nl):
        t = cols[i] + carry
        m = (t * n0) & mask
        carry = (t + m * p[0]) >> bits
        for j in range(1, nl):
            cols[i + j] += m * p[j]
    out, c = [], carry
    for k in range(nl, 2 * nl):
        v = cols[k] + c
        out.append(v & mask)
        c = v >> bits
    return out


@pytest.mark.parametrize("bits", [16, 8])
def test_plain_chain_matches_jax_body(jub, bits):
    a, b, body, chain = ((_A16, _B16, jub.mont16_kernel, tub.mont16_chain) if bits == 16
                         else (_A8, _B8, jub.mont8_kernel, tub.mont8_chain))
    want = _interpret(body, a, b)
    got = chain(torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)),
                ITERS)
    assert got.dtype == torch.int32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("bits", [16, 8])
def test_plain_step_matches_integer_model(bits):
    """One product on columns with the edge limbs, against Python ints (the
    16-bit radix splits each limb product into lo/hi halves, which sums to
    the same columns)."""
    a, b = (_A16, _B16) if bits == 16 else (_A8, _B8)
    got = tub.mont_chain_plain(torch.from_numpy(a[:, :8].astype(np.int32)),
                               torch.from_numpy(b[:, :8].astype(np.int32)), 1, bits)
    for col in range(8):
        want = _int_model_step([int(x) for x in a[:, col]], [int(x) for x in b[:, col]], bits)
        assert got[:, col].tolist() == want, col


def test_wrappers_check_shapes_and_raw_probes():
    a = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tub.mont8_chain(a, a)
    t = tub.inputs(64, device="cpu")
    x = tub.raw_mulmask_chain(t["flat_a"], t["flat_b"], 1)
    want = t["flat_a"].numpy().astype(np.uint32)
    bb = t["flat_b"].numpy().astype(np.uint32)
    for _ in range(64):
        tt = want * bb
        want = (tt & np.uint32(0xFFFF)) + (tt >> np.uint32(16))
    np.testing.assert_array_equal(x.numpy().astype(np.uint32), want)
    y = tub.raw_mul_chain(t["flat_a"], t["flat_b"], 1).numpy().astype(np.uint32)
    w = t["flat_a"].numpy().astype(np.uint32)
    for _ in range(64):
        w = w * bb
    np.testing.assert_array_equal(y, w)


def test_main_runs_on_cpu_when_asked(capsys):
    out = tub.main(["6", "1"], device="cpu")
    assert set(out) == {"raw_mul", "raw_mulmask", "raw_f32", "mont16", "mont8"}
    assert "mont_mul 16x16b" in capsys.readouterr().out
