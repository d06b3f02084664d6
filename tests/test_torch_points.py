"""XYZZ point ops of the port (plain K2/K3 on CPU) against
nova_tpu.curves.jpoints on CPU (its XLA branch). Bitwise, including
identity lanes, P = Q and P = -Q."""

import jax.numpy as jnp
import numpy as np
import torch

from nova_tpu.curves import jpoints
from nova_tpu.curves.spec import AffinePoint, pallas
from nova_tpu.fields.jfield import JField

from nova_tpu_torch.curves import points
from nova_tpu_torch.fields import spec as tspec
from nova_tpu_torch.fields.tfield import TField

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

KEYS = ("x", "y", "zz", "zzz")
N = 48


def _inputs():
    """P affine-as-XYZZ, Q = 2 * (other points) in XYZZ; lanes 0-3 P
    identity, 4-7 Q identity, 8-11 both, 12-15 Q = P, 16-19 Q = -P."""
    jf = JField(pallas.base)
    rng = np.random.default_rng(9)
    g = AffinePoint.generator(pallas)
    pts = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(2 * N)]
    to_mont = jf.jit("to_mont")
    x = to_mont(jnp.asarray(jf.pack([p.x for p in pts])))
    y = to_mont(jnp.asarray(jf.pack([p.y for p in pts])))
    inf = jnp.zeros((2 * N,), bool)
    A = jpoints.xyzz_from_affine(jf, x, y, inf)
    P = {k: np.array(v[:N]) for k, v in A.items()}
    Q = {k: np.array(v) for k, v in jpoints.xyzz_double(jf, {k: v[N:] for k, v in A.items()}).items()}
    for k in ("zz", "zzz"):
        P[k][0:4] = 0
        Q[k][4:8] = 0
        P[k][8:12] = 0
        Q[k][8:12] = 0
    for k in KEYS:
        Q[k][12:20] = P[k][12:20]
    Q["y"][16:20] = np.asarray(jf.neg(jnp.asarray(P["y"][16:20])))
    return jf, P, Q


def _t(d):
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in d.items()}


def _same(j, t):
    return all(
        np.array_equal(np.asarray(j[k]).astype(np.int64), t[k].numpy()) for k in KEYS
    )


def test_xyzz_add_double_bitwise():
    jf, P, Q = _inputs()
    tf = TField(tspec.pallas_base)
    jP = {k: jnp.asarray(v) for k, v in P.items()}
    jQ = {k: jnp.asarray(v) for k, v in Q.items()}
    got = points.xyzz_add(tf, _t(P), _t(Q))
    assert _same(jpoints.xyzz_add(jf, jP, jQ), got)
    # the identity, doubling and inverse lanes really took their branches
    assert got["zz"][0:12].eq(0).all(-1).tolist() == [False] * 8 + [True] * 4
    assert got["zz"][16:20].eq(0).all()
    assert _same(jpoints.xyzz_add(jf, jQ, jP), points.xyzz_add(tf, _t(Q), _t(P)))
    assert _same(jpoints.xyzz_double(jf, jQ), points.xyzz_double(tf, _t(Q)))
    assert _same(jpoints.xyzz_double(jf, jP), points.xyzz_double(tf, _t(P)))


def test_xyzz_helpers_bitwise():
    jf, P, _ = _inputs()
    tf = TField(tspec.pallas_base)
    inf = np.arange(N) % 5 == 0
    jz = jpoints.xyzz_zero(jf, jnp.asarray(P["x"]))
    tz = points.xyzz_zero(tf, torch.from_numpy(P["x"].astype(np.int32)))
    assert _same(jz, tz)
    ja = jpoints.xyzz_from_affine(jf, jnp.asarray(P["x"]), jnp.asarray(P["y"]), jnp.asarray(inf))
    ta = points.xyzz_from_affine(
        tf, torch.from_numpy(P["x"].astype(np.int32)),
        torch.from_numpy(P["y"].astype(np.int32)), torch.from_numpy(inf),
    )
    assert _same(ja, ta)
    assert points.xyzz_is_zero(tf, ta).numpy().tolist() == inf.tolist()
