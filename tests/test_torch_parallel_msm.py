"""msm_sharded (``nova_tpu_torch.parallel``) on 4- and 8-device CPU meshes
at lengths that are not powers of two, with infinity bases and zero
scalars, against the JAX package's host Pippenger; and the shard layout of
its inputs (every window cut per shard); HVec and FVec scalars. The precompute is the native one
(``test_torch_parallel.native_fixed``). Tolerance: exact."""

import random

import pytest
import torch

from nova_tpu_torch import parallel
from nova_tpu_torch.curves.spec import AffinePoint, pallas
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm3
from nova_tpu_torch.ops.msm2 import DeviceBases2

from tests.test_torch_parallel import chain, jhost, native_precompute, xy  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("n,D", [(64, 8), (300, 4), (300, 8)])
def test_msm_sharded_matches_host(n, D, native_precompute):
    """Non-power-of-two lengths, infinity bases and zero scalars, on 4- and
    8-device meshes."""
    rng = random.Random(n * D)
    bases = chain(n, 3)
    bases[7] = AffinePoint.identity(pallas)
    scalars = [rng.randrange(pallas.scalar.p) for _ in range(n)]
    scalars[11] = 0
    got = parallel.msm_sharded(scalars, bases, mesh=parallel.make_mesh(D, devices=["cpu"] * D))
    assert xy(got) == jhost(scalars, bases)


def test_shard_inputs_cut_every_window(native_precompute):
    """Shard d holds points [d n_loc, (d+1) n_loc) in every window, window
    by window; its digits are those of its own scalars."""
    D, c = 4, 8
    bases = chain(20)
    scalars = list(range(1, 21))
    db = DeviceBases2(pallas, bases, device="cpu")
    mesh = parallel.make_mesh(D, devices=["cpu"] * D)
    shards = parallel.shard_msm_inputs(scalars, db, mesh, c)
    fx, _, _, finf = db.fixed(c, 512)
    W = msm3._num_windows(c)
    n_loc = 512 // D
    u = msm3.add_offset_device(
        torch.from_numpy(TField(pallas.scalar).pack(scalars + [0] * 492)), c, W)
    full_d = msm3.offset_digits_device(u, c, W)  # (W, 512)
    for d, (digits, sx, _, _, sinf) in enumerate(shards):
        rows = (torch.arange(W)[:, None] * 512 + d * n_loc + torch.arange(n_loc)).reshape(-1)
        assert torch.equal(sx, fx[rows]) and torch.equal(sinf, finf[rows])
        assert torch.equal(digits, full_d[:, d * n_loc : (d + 1) * n_loc].reshape(-1))
    assert bool((shards[1][0] == 0).all())  # pad lanes: digit 0


def test_msm_sharded_takes_hvec_and_fvec(native_precompute):
    """An HVec (its uint64 limbs) and an FVec (its Montgomery rows, from_mont
    on its device) give the int list's point on a 2-device mesh."""
    from nova_tpu_torch.ops.fvec import FVec, HVec

    rng = random.Random(21)
    bases = chain(40, 5)
    scalars = [rng.randrange(pallas.scalar.p) for _ in range(40)]
    db = DeviceBases2(pallas, bases, device="cpu")
    mesh = parallel.make_mesh(2, devices=["cpu"] * 2)
    want = jhost(scalars, bases)
    for v in (HVec(pallas.scalar.p, ints=scalars),
              FVec.from_ints(pallas.scalar, scalars, device="cpu")):
        assert xy(parallel.msm_sharded(v, mesh=mesh, device_bases=db)) == want


def test_shard_blocks_cached_per_mesh_until_the_precompute_changes(native_precompute):
    """Each shard's block of the window-shifted bases is cut once per
    (window, size, devices) and reused by later commits; installing a new
    precompute for that window and size drops the cut blocks."""
    c = 8
    bases = chain(20)
    scalars = list(range(1, 21))
    db = DeviceBases2(pallas, bases, device="cpu")
    mesh4 = parallel.make_mesh(4, devices=["cpu"] * 4)
    first = parallel.shard_msm_inputs(scalars, db, mesh4, c)
    again = parallel.shard_msm_inputs(scalars[::-1], db, mesh4, c)
    assert all(a[k] is b[k] for a, b in zip(first, again) for k in range(1, 5))
    assert len(parallel.shard_msm_inputs(scalars, db, parallel.make_mesh(
        2, devices=["cpu"] * 2), c)) == 2 and len(db._shards) == 2
    fx, fy, _, finf = db.fixed(c, 512)
    db.set_fixed(c, 512, fx.clone(), fy, finf)
    assert not db._shards
    fresh = parallel.shard_msm_inputs(scalars, db, mesh4, c)
    assert fresh[0][1] is not first[0][1] and torch.equal(fresh[0][1], first[0][1])
