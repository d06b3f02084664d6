"""The field product shared by every kernel of the port, K1's one-row
operands and K2's identity lanes, on the CPU, against the JAX package.

(a) ``fields/kernels.mont_mul`` (plain on CPU tensors) with a one-row
operand on either side and at the sumcheck bind's shapes, bitwise against
``JField.mont_mul`` on the same numpy inputs, for every field; and the
wrapper's test for a one-row operand (``one_row``), which decides on a CUDA
tensor whether K1 reads the row in place.
(b) A Python-integer model of ``csrc/field.cuh::fe_mul``'s word schedule
(the same partial products, carries and final subtract, op for op),
bitwise against ``LimbOps.mul``, the JAX package's product and the
contract T = (a*b + m*p) / 2^256, minus p once when T >= p or T >= 2^256,
on edge values and seeded values in [0, 2^256), for every field.
(c) K2's plain version on identity-heavy tables shaped like a commit's
bucket totals, bitwise against ``nova_tpu.ops.msm2._xyzz_add_limbs``.
(d) The model's lazy ending (``csrc/field.cuh::fe_mul_lazy``: no subtract,
the carry word dropped, which is what P1/P2 chain), bitwise against the
field microbenchmark's plain chains (``perf/ubench_field.py::
mont_chain_plain`` of the port) in radix 2^16 and 2^8 and against the JAX
package's TPU bodies ``mont16_kernel``/``mont8_kernel`` in Pallas interpret
mode, at ITERS 1 and 3, on edge columns (all limbs 0, all limbs 2^BITS - 1,
p's limbs, 1) and seeded ones; the same chain with the subtract kept, or
with the carry word kept, must differ. The JAX module is imported with its
argv patched to N = 256, ITERS = 1, as ``tests/test_torch_ubench.py``
imports it; each body is compiled once (XLA's compile of the unrolled body
is most of this file's time) and ITERS = 3 is three launches of it.
"""

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

from nova_tpu.fields import spec as jspec
from nova_tpu.fields.jfield import JField
from nova_tpu.ops import msm2 as jmsm2

from nova_tpu_torch.fields import kernels as fk
from nova_tpu_torch.fields import spec as tspec
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.perf import ubench_field as tub

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

FIELDS = sorted(tspec.ALL_FIELDS)
M32 = (1 << 32) - 1
N = 64


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def _edges(p, r):
    return [0, 1, p - 1, p, (1 << 256) - 1, r]


# -- (a) one-row operands ------------------------------------------------------


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_one_row_operands_bitwise(name):
    js, ts = jspec.ALL_FIELDS[name], tspec.ALL_FIELDS[name]
    jf, tf = JField(js), TField(ts)
    rng = np.random.default_rng(11)
    vals = _edges(js.p, js.r) + [int.from_bytes(rng.bytes(32), "little")
                                 for _ in range(3 * N - 6)]
    a = jf.pack(vals)                                  # (3N, 16)
    row = jf.pack([(1 << 256) - 1])[0]                 # non-canonical
    bind_row = np.asarray(tf.const_mont(12345, _t(row))).astype(np.uint32)
    for r in (row, bind_row):
        # eager: JField.mont_mul is a few hundred XLA ops, cheaper run than
        # compiled on the CPU at these sizes
        want = jf.mont_mul(jnp.asarray(a), jnp.asarray(np.broadcast_to(r, a.shape)))
        assert _eq(want, fk.mont_mul(tf, _t(a), _t(r)))                 # row right
        assert _eq(want, fk.mont_mul(tf, _t(r), _t(a)))                 # row left
        a3 = _t(a).view(3, N, 16)                      # the bind's (3, n, 16)
        got = fk.mont_mul(tf, _t(r).expand(a3.shape), a3)
        assert got.shape == a3.shape
        assert _eq(want, got.reshape(-1, 16))


def test_one_row_detects_broadcast_rows():
    shape = (3, 5, 16)
    row = torch.arange(16, dtype=torch.int32)
    for t in (row, row[None], row[None, None], row.expand(shape),
              torch.zeros((1, 1, 16), dtype=torch.int32)):
        got = fk.one_row(t, shape)
        assert got is not None and got.shape == (16,) and got.is_contiguous()
        assert torch.equal(got, t.reshape(-1, 16)[0])
    for t in (torch.zeros(shape, dtype=torch.int32),
              torch.zeros((3, 1, 16), dtype=torch.int32),
              torch.zeros((5, 16), dtype=torch.int32)):
        assert fk.one_row(t, shape) is None
    assert fk.one_row(row, (16,)) is not None


# -- (b) the product's word schedule -------------------------------------------


class _Carry:
    """The PTX carry-flag instructions fe_mul uses, on 32-bit words."""

    def __init__(self):
        self.cf = 0

    def _set(self, v):
        self.cf = v >> 32
        return v & M32

    def add_cc(self, x, y):
        return self._set(x + y)

    def addc_cc(self, x, y):
        return self._set(x + y + self.cf)

    def addc(self, x, y):
        return (x + y + self.cf) & M32

    def mad_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._set(((a * b) >> 32) + c + self.cf)


def _mul_row0(ev, od, A, bi):
    for j in range(0, 8, 2):
        ev[j], ev[j + 1] = (A[j] * bi) & M32, (A[j] * bi) >> 32
        od[j], od[j + 1] = (A[j + 1] * bi) & M32, (A[j + 1] * bi) >> 32


def _mul_row(c, e, o, x, A, bi):
    """field.cuh::mul_row; returns the new carry word x."""
    e[0] = c.add_cc(e[0], o[1])
    for j in range(0, 6, 2):
        o[j] = c.madc_lo_cc(A[j + 1], bi, o[j + 2])
        o[j + 1] = c.madc_hi_cc(A[j + 1], bi, o[j + 3])
    o[6] = c.madc_lo_cc(A[7], bi, 0)
    o[7] = c.madc_hi_cc(A[7], bi, x)
    x = c.addc(0, 0)
    e[0] = c.mad_lo_cc(A[0], bi, e[0])
    e[1] = c.madc_hi_cc(A[0], bi, e[1])
    for j in range(2, 8, 2):
        e[j] = c.madc_lo_cc(A[j], bi, e[j])
        e[j + 1] = c.madc_hi_cc(A[j], bi, e[j + 1])
    o[7] = c.addc_cc(o[7], 0)
    return c.addc(x, 0)


def _redc_row(c, ev, od, x, P, n0):
    """field.cuh::redc_row; returns the new carry word x."""
    m = (ev[0] * n0) & M32
    od[0] = c.mad_lo_cc(P[1], m, od[0])
    od[1] = c.madc_hi_cc(P[1], m, od[1])
    for j in range(2, 8, 2):
        od[j] = c.madc_lo_cc(P[j + 1], m, od[j])
        od[j + 1] = c.madc_hi_cc(P[j + 1], m, od[j + 1])
    x = c.addc(x, 0)
    ev[0] = c.mad_lo_cc(P[0], m, ev[0])
    ev[1] = c.madc_hi_cc(P[0], m, ev[1])
    for j in range(2, 8, 2):
        ev[j] = c.madc_lo_cc(P[j], m, ev[j])
        ev[j + 1] = c.madc_hi_cc(P[j], m, ev[j + 1])
    assert ev[0] == 0
    od[7] = c.addc_cc(od[7], 0)
    return c.addc(x, 0)


def fe_mul_model(a: int, b: int, p: int, ending: str = "sub") -> int:
    """csrc/field.cuh::fe_mul (ending "sub"), or fe_mul_lazy ("lazy": T mod
    2^256, no subtract, the carry word dropped), op for op, on Python ints.
    "carry" is a mutation of the lazy ending that keeps the carry word."""
    A, B, P = ([(v >> (32 * k)) & M32 for k in range(8)] for v in (a, b, p))
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    c = _Carry()
    u, v, x = [0] * 8, [0] * 8, 0
    _mul_row0(u, v, A, B[0])
    x = _redc_row(c, u, v, x, P, n0)
    for i in range(1, 8, 2):  # the accumulators swap roles each row
        x = _mul_row(c, v, u, x, A, B[i])
        x = _redc_row(c, v, u, x, P, n0)
        if i + 1 < 8:
            x = _mul_row(c, u, v, x, A, B[i + 1])
            x = _redc_row(c, u, v, x, P, n0)
    t = [c.add_cc(u[0], v[1])]
    t += [c.addc_cc(u[j], v[j + 1]) for j in range(1, 7)]
    t.append(c.addc_cc(u[7], 0))
    if ending == "lazy":
        return sum(w << (32 * k) for k, w in enumerate(t))
    top = c.addc(x, 0)
    if ending == "carry":
        return sum(w << (32 * k) for k, w in enumerate(t + [top]))
    # fe_cond_sub: one subtract of p when T >= p or T overflows 2^256
    d, borrow = [], 0
    for j in range(8):
        w = t[j] - P[j] - borrow
        d.append(w & M32)
        borrow = int(w < 0)
    words = d if (borrow == 0 or top != 0) else t
    return sum(w << (32 * k) for k, w in enumerate(words))


def _contract(a, b, p):
    R = 1 << 256
    m = -a * b * pow(p, -1, R) % R
    T = (a * b + m * p) >> 256
    return (T - p) % R if T >= p else T


@pytest.mark.parametrize("name", FIELDS)
def test_product_schedule_model_bitwise(name):
    js, ts = jspec.ALL_FIELDS[name], tspec.ALL_FIELDS[name]
    jf, tf = JField(js), TField(ts)
    rng = np.random.default_rng(12)
    vals = _edges(js.p, js.r) + [int.from_bytes(rng.bytes(32), "little") for _ in range(10)]
    pairs = [(x, y) for x in vals for y in vals]
    model = [fe_mul_model(x, y, js.p) for x, y in pairs]
    assert model == [_contract(x, y, js.p) for x, y in pairs]
    a = jf.pack([x for x, _ in pairs])
    b = jf.pack([y for _, y in pairs])
    want = jf.pack(model)
    assert _eq(jf.mont_mul(jnp.asarray(a), jnp.asarray(b)), _t(want))
    assert _eq(want, tf.ops("cpu").mul(_t(a).long(), _t(b).long()))


# -- (c) K2 on identity-heavy tables ---------------------------------------------


def test_xyzz_add_plain_identity_heavy_bitwise():
    """Two 2,048-row halves: about 78% of lanes with both operands live (as
    in a commit's first bucket-total add) and about 12% (as in its second),
    the rest with P, Q or both the identity, plus P = Q and P = -Q lanes."""
    rows = 4096
    js = jspec.ALL_FIELDS["pallas_base"]
    jf, tf = JField(js), TField(tspec.ALL_FIELDS["pallas_base"])
    rng = np.random.default_rng(13)
    v = rng.integers(0, 1 << 16, size=(8, rows, 16), dtype=np.int64)
    v[..., 15] &= 0x3FFF  # below 2^254 < p
    P = {k: v[i].copy() for i, k in enumerate(fk.KEYS)}
    Q = {k: v[4 + i].copy() for i, k in enumerate(fk.KEYS)}
    half = rows // 2
    u = rng.random(rows)
    w = rng.random(rows)
    p_id = np.where(np.arange(rows) < half, u < 0.12, u < 0.30)
    q_id = np.where(np.arange(rows) < half, w < 0.12, w < 0.83)
    for k in ("zz", "zzz"):
        P[k][p_id] = 0
        Q[k][q_id] = 0
    for k in fk.KEYS:
        Q[k][100:110] = P[k][100:110]           # P = Q
        Q[k][200:210] = P[k][200:210]
    Q["y"][200:210] = tf.neg(_t(P["y"][200:210])).numpy()   # P = -Q
    live = ~p_id & ~q_id
    assert 0.7 < live[:half].mean() < 0.85 and 0.05 < live[half:].mean() < 0.2

    o = jmsm2._limb_ops(*jmsm2._field_key(jf)[1:])
    want = jmsm2._xyzz_add_limbs(
        o, *(tuple([jnp.asarray(d[k][:, i].astype(np.uint32)) for i in range(16)]
                   for k in fk.KEYS) for d in (P, Q)))
    got = fk.xyzz_add(tf, {k: _t(x) for k, x in P.items()}, {k: _t(x) for k, x in Q.items()})
    for k, limbs in zip(fk.KEYS, want):
        assert _eq(np.stack([np.asarray(l) for l in limbs], axis=1), got[k]), k


# -- (d) the lazy ending: the field microbenchmark's chains --------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UB_COLS = 32


def _ub_operands():
    """Column pairs: every pair of the edge values, then seeded values."""
    edges = [0, (1 << 256) - 1, tub.P, 1]
    rng = np.random.default_rng(14)
    pairs = [(x, y) for x in edges for y in edges]
    pairs += [tuple(int.from_bytes(rng.bytes(32), "little") for _ in range(2))
              for _ in range(UB_COLS - len(pairs))]
    return [x for x, _ in pairs], [y for _, y in pairs]


_UB_A, _UB_B = _ub_operands()


def _limb_rows(vals, bits):
    mask = (1 << bits) - 1
    return np.array([[(v >> (bits * i)) & mask for v in vals] for i in range(256 // bits)],
                    dtype=np.uint32)


def _values(rows, bits):
    rows = np.asarray(rows).astype(np.int64)
    return [sum(int(rows[i, c]) << (bits * i) for i in range(rows.shape[0]))
            for c in range(rows.shape[1])]


def _lazy_contract(a, b, p):
    """((a*b + m*p) / 2^256) mod 2^256, m = -a*b*p^-1 mod 2^256."""
    R = 1 << 256
    m = -a * b * pow(p, -1, R) % R
    return ((a * b + m * p) >> 256) % R


def _model_chains(iters, ending):
    """Each column's chain of `iters` products: fe_mul_model with `ending`,
    or `ending` itself when it is a function."""
    step = ending if callable(ending) else (lambda a, b, p: fe_mul_model(a, b, p, ending))
    out = []
    for a, b in zip(_UB_A, _UB_B):
        for _ in range(iters):
            a = step(a, b, tub.P)
        out.append(a)
    return out


@pytest.fixture(scope="module")
def jax_bodies():
    """{bits: the TPU body at ITERS = 1 in one jitted pallas_call in
    interpret mode, on (NL, UB_COLS) uint32 limbs}."""
    spec = importlib.util.spec_from_file_location(
        "_jax_ubench_field_lazy", os.path.join(ROOT, "perf", "ubench_field.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["ubench_field.py", "8", "1"]):
        spec.loader.exec_module(mod)
    assert mod.ITERS == 1
    return {bits: jax.jit(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((256 // bits, UB_COLS), jnp.uint32),
        grid=(1,), interpret=True))
        for bits, body in ((16, mod.mont16_kernel), (8, mod.mont8_kernel))}


def test_ubench_field_is_the_spec_pallas_base():
    """P1/P2's kernel takes fields/spec.py's Pallas base constants."""
    tf = TField(tspec.pallas_base)
    assert tspec.pallas_base.p == tub.P
    assert sum(int(w) << (32 * k) for k, w in enumerate(tf.consts32[:8])) == tub.P
    assert int(tf.consts32[16]) == -pow(tub.P, -1, 1 << 32) % (1 << 32)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("bits", [16, 8])
def test_lazy_product_model_matches_chains(jax_bodies, bits, iters):
    model = _model_chains(iters, "lazy")
    assert model == _model_chains(iters, _lazy_contract)
    A, B = _limb_rows(_UB_A, bits), _limb_rows(_UB_B, bits)
    plain = tub.mont_chain_plain(torch.from_numpy(A.astype(np.int32)),
                                 torch.from_numpy(B.astype(np.int32)), iters, bits)
    assert _values(plain.numpy(), bits) == model
    got, jb = jnp.asarray(A), jnp.asarray(B)
    for _ in range(iters):
        got = jax_bodies[bits](got, jb)
    assert _values(got, bits) == model


def test_lazy_ending_mutations_differ():
    """The chains above catch a product that keeps its subtract, or keeps
    the carry word (the all-ones column's first product passes 2^256)."""
    for iters in (1, 3):
        assert _model_chains(iters, "sub") != _model_chains(iters, "lazy")
    assert _model_chains(1, "carry") != _model_chains(1, "lazy")
