"""The port's device mesh (``nova_tpu_torch.parallel``) on CPU meshes that
repeat one device (``["cpu"] * D``, as the JAX tests run on virtual CPU
devices): make_mesh/use_mesh, and msm_sharded against the JAX package's
msm_sharded on ``make_mesh(4)``, its host Pippenger and the port's
msm_device3.

The window-shifted precompute that msm3 reads (plain K3 on CPU tensors,
held against the JAX package in test_torch_msm.py) is computed here by the
native binding, as the JAX package's host precompute (``_fixed3_host``)
does: ``native_fixed`` holds the two equal, and the ``native_precompute``
fixture installs it so the sharded MSMs at 2^9 - 2^14 points stay fast.

Tolerance: exact (points equal in affine form)."""

import random

import pytest
import torch

from nova_tpu.curves.msm_host import msm as jhost_msm
from nova_tpu.curves.spec import AffinePoint as JAffine, pallas as JPALLAS
from nova_tpu.parallel import make_mesh as jmake_mesh, msm_sharded as jmsm_sharded

from nova_tpu_torch import native, parallel
from nova_tpu_torch.curves.spec import AffinePoint, pallas
from nova_tpu_torch.ops import msm2, msm3
from nova_tpu_torch.ops.msm2 import DeviceBases2

torch.set_num_threads(1)


def native_fixed(db, c: int, n_pad: int):
    """DeviceBases2.fixed with the shifted bases from the native binding's
    [2^c]P (the JAX package's _fixed3_host): same rows, same flags."""
    key = (c, n_pad)
    if key not in db._fixed:
        tf, curve = db.tf, db.curve
        xs, ys = tf.unpack(tf.from_mont(db.x)), tf.unpack(tf.from_mont(db.y))
        ident = AffinePoint.identity(curve)
        pts = [ident if inf else AffinePoint(curve, x, y)
               for x, y, inf in zip(xs, ys, db.inf.tolist())]
        cur = (pts + [ident] * n_pad)[:n_pad]
        rows = []
        for w in range(msm2._num_windows2(c)):
            if w:
                cur = native.ec_scale(cur, 1 << c)
            rows += cur
        dev = db.x.device
        q, R = tf.spec.p, 1 << 256

        def mont(vals):  # Montgomery form x * 2^256 mod p, on the host
            return torch.from_numpy(tf.pack([v * R % q for v in vals])).to(dev)

        db.set_fixed(c, n_pad, mont([0 if p.infinity else p.x for p in rows]),
                     mont([0 if p.infinity else p.y for p in rows]),
                     torch.tensor([p.infinity for p in rows], device=dev))
    return db._fixed[key]


@pytest.fixture
def native_precompute(monkeypatch):
    monkeypatch.setattr(DeviceBases2, "fixed", native_fixed)


def chain(n, start=1):
    bases, acc = [], AffinePoint.generator(pallas).mul(start)
    for _ in range(n):
        bases.append(acc)
        acc = acc.double()
    return bases


def jhost(scalars, bases):
    pts = [JAffine.identity(JPALLAS) if b.infinity else JAffine(JPALLAS, b.x, b.y)
           for b in bases]
    r = jhost_msm(list(scalars), pts)
    return (r.x, r.y, r.infinity)


def xy(p):
    return (p.x, p.y, p.infinity)


def test_native_fixed_matches_plain_precompute():
    bases = chain(5) + [AffinePoint.identity(pallas)]
    db = DeviceBases2(pallas, bases, device="cpu")
    c, n_pad, W = 8, 8, 4  # the first 4 of the 33 windows
    bx, by, binf = msm2._sized(db, n_pad)
    fx, fy, finf = msm2._precompute_shifted(db.tf, c, W, bx, by, binf)
    nx, ny, _, ninf = (t[: W * n_pad] for t in native_fixed(db, c, n_pad))
    assert torch.equal(finf, ninf)
    live = ~finf
    assert torch.equal(fx[live], nx[live]) and torch.equal(fy[live], ny[live])


def test_make_mesh_and_use_mesh():
    mesh = parallel.make_mesh(4, devices=["cpu"] * 8)
    assert mesh.size == 4 and mesh.axis_name == "pts"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert parallel.make_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        parallel.make_mesh(5, devices=["cpu"] * 4)
    assert parallel.current_mesh() is None
    other = parallel.make_mesh(2, devices=["cpu"] * 2)
    with parallel.use_mesh(mesh) as m:
        assert m is mesh and parallel.current_mesh() is mesh
        with parallel.use_mesh(other):
            assert parallel.current_mesh() is other
        assert parallel.current_mesh() is mesh
    assert parallel.current_mesh() is None
    with pytest.raises(ValueError):
        parallel.msm_sharded([1, 2], chain(2))


def test_msm_sharded_matches_reference_at_64(native_precompute):
    """D = 4 over 64 points (shards of 128 lanes, padding included) equals
    the JAX package's msm_sharded on its 4-device mesh, the host Pippenger
    and the port's single-device msm_device3."""
    rng = random.Random(0xD15C)
    bases = chain(64)
    scalars = [rng.randrange(pallas.scalar.p) for _ in range(64)]
    db = DeviceBases2(pallas, bases, device="cpu")
    got = parallel.msm_sharded(scalars, mesh=parallel.make_mesh(4, devices=["cpu"] * 4),
                               device_bases=db)
    want = jhost(scalars, bases)
    assert xy(got) == want
    assert xy(msm3.msm_device3(scalars, device_bases=db, window=8)) == want
    jbases = [JAffine(JPALLAS, b.x, b.y) for b in bases]
    assert xy(jmsm_sharded(scalars, jbases, jmake_mesh(4))) == want


def test_tree_reduce_adds_in_device_order():
    from nova_tpu_torch.curves.points import KEYS, xyzz_from_affine
    from nova_tpu_torch.fields.tfield import TField

    tf = TField(pallas.base)
    pts = chain(5)
    x = tf.to_mont(torch.from_numpy(tf.pack([p.x for p in pts])))
    y = tf.to_mont(torch.from_numpy(tf.pack([p.y for p in pts])))
    g = xyzz_from_affine(tf, x, y, torch.zeros(5, dtype=torch.bool))
    acc = parallel._tree_reduce_points(tf, g)
    assert set(acc) == set(KEYS) and acc["x"].shape == (1, 16)
    want = pts[0]
    for p in pts[1:]:
        want = want.add(p)
    got = {k: tf.unpack(tf.from_mont(v))[0] for k, v in acc.items()}
    f = pallas.base
    assert (f.mul(got["x"], f.inv(got["zz"])), f.mul(got["y"], f.inv(got["zzz"]))) == (
        want.x, want.y)
