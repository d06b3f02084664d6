"""Device mesh: sharded MSM, sharded fold drill and sharded outer sumcheck
(port of ``nova_tpu/parallel/__init__.py``; the reference is single-process
rayon, and this axis is what the accelerator rebuild adds over it).

A ``Mesh`` is one process driving a list of devices along one named axis,
as a JAX mesh is; shard d of a split lives on ``mesh.devices[d]``. A list
may repeat one device (``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the
tests), which runs the same split, per-shard kernels and reductions one
shard after another: that shows the sharded programs are right, not that
they scale.

Decomposition:
- MSM: points split into D contiguous blocks; each device runs the msm3
  fixed-base core (sort, K4 in complete mode, K2s/K2 bucket totals, K5)
  over its block in every window, giving one XYZZ point; the D points go
  to the first device and add in device order (K2).
- Elementwise folds and the cross-term T: data-parallel on the vector
  axis (K1 per shard), no communication; the sumcheck-style partial sums
  reduce exactly on the first device.
- Outer sumcheck rounds: tables laid out (n/D, D, 16), shard d holding the
  indices = d mod D; each round's three sums are per-shard partial field
  sums (K1) added exactly on the first device, binds stay local, and the
  last log2(D) variables finish on the host. Proofs are bit-identical to
  the host prover's.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np
import torch

from nova_tpu_torch._device import resolve
from nova_tpu_torch.curves.points import KEYS, xyzz_add
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm3
from nova_tpu_torch.ops.fvec import FVec, HVec
from nova_tpu_torch.ops.msm2 import DeviceBases2, _next_pow2, _xyzz_row_to_affine
from nova_tpu_torch.ops.sumcheck import _field_tree_sum as _field_sum
from nova_tpu_torch.ops.sumcheck import _std_limbs16, bind_top, cubic_round_sums


class Mesh:
    """A 1-D device mesh: `devices` (a list of torch.device, repeats
    allowed) along the axis `axis_name`."""

    def __init__(self, devices: Sequence, axis_name: str = "pts"):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis_name={self.axis_name!r})"


_ACTIVE_MESH: Optional[Mesh] = None


class use_mesh:
    """Context manager making a mesh the active commit and sumcheck target:
    while active, CommitmentEngine.commit routes MSMs of 8 or more entries
    through msm_sharded, and Spartan's outer sumcheck is sharded."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "pts",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first n of `devices` (all CUDA devices when not
    given; all of them when n is not given). A CUDA entry without a card
    raises."""
    if devices is None:
        resolve()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} devices from a list of {len(devs)}")
    return Mesh(devs[:n], axis_name)


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------


def _tree_reduce_points(tf: TField, gathered: dict) -> dict:
    """Fold a (D, 16)-per-coordinate stack of XYZZ points into one (1, 16)
    point, adding in device order (D - 1 launches of K2)."""
    acc = {k: v[0:1] for k, v in gathered.items()}
    for i in range(1, gathered["x"].shape[0]):
        acc = xyzz_add(tf, acc, {k: v[i : i + 1] for k, v in gathered.items()})
    return acc


def _scalar_limbs16(scalars, p: int, dev) -> torch.Tensor:
    """(n, 16) int32 standard-form 16-bit limbs of the scalars reduced mod
    p: an FVec's from its Montgomery rows (on its device), an HVec's from
    its limbs, an int list's from the ints."""
    if isinstance(scalars, FVec):
        return scalars.tf.from_mont(scalars.m)
    if not isinstance(scalars, HVec):
        scalars = [int(s) % p for s in scalars]
    return torch.from_numpy(_std_limbs16(scalars)).to(dev)


def _shard_bases(device_bases, mesh: Mesh, c: int, n_pad: int):
    """Each shard's block of the window-shifted bases on its device: (fx,
    fy, fyneg, finf) with W*n_loc rows, cached on the DeviceBases2 per
    (window, size, devices) beside its precompute. The precompute lays
    window w's rows at [w*n_pad, (w+1)*n_pad), so a block is one slice of
    each window, not one slice of rows."""
    key = (c, n_pad, tuple(mesh.devices))
    if key not in device_bases._shards:
        D = mesh.size
        n_loc = n_pad // D
        W = msm3._num_windows(c)
        fixed = device_bases.fixed(c, n_pad)
        device_bases._shards[key] = [
            [t.reshape(W, n_pad, *t.shape[1:])[:, d * n_loc : (d + 1) * n_loc]
             .reshape(W * n_loc, *t.shape[1:]).to(dev) for t in fixed]
            for d, dev in enumerate(mesh.devices)]
    return device_bases._shards[key]


def shard_msm_inputs(scalars, device_bases, mesh: Mesh, c: int):
    """Each shard's msm3 input on its device: (digits (W*n_loc,) int32
    signed, window-major, and its block of the window-shifted bases fx, fy,
    fyneg (W*n_loc, 16), finf (W*n_loc,); see _shard_bases). Pad lanes
    carry scalar 0 (digit 0) over identity bases: inert."""
    D = mesh.size
    n = len(scalars)
    n_pad = max(512, _next_pow2(n), D)
    if n_pad % D:
        raise ValueError(f"{n_pad} padded points do not split over {D} devices")
    n_loc = n_pad // D
    W = msm3._num_windows(c)
    s16 = _scalar_limbs16(scalars, device_bases.curve.scalar.p, device_bases.x.device)
    if n_pad > n:
        s16 = torch.cat([s16, s16.new_zeros((n_pad - n, NUM_LIMBS))])
    out = []
    for d, (dev, blocks) in enumerate(zip(mesh.devices,
                                          _shard_bases(device_bases, mesh, c, n_pad))):
        u = msm3.add_offset_device(s16[d * n_loc : (d + 1) * n_loc].to(dev), c, W)
        digits = msm3.offset_digits_device(u, c, W).reshape(W * n_loc)
        out.append((digits, *blocks))
    return out


def msm_sharded(scalars, bases=None, mesh: Optional[Mesh] = None,
                window: Optional[int] = None, device_bases=None):
    """MSM with the points split over the mesh's devices (host ints, an
    HVec or an FVec in; an AffinePoint out) on the msm3 fixed-base core in
    complete mode. `device_bases` (a DeviceBases2) reuses a key's
    window-shifted precompute across calls (the Pedersen path); otherwise
    the bases are marshalled on the mesh's first device. The window is 16
    on CUDA bases and 8 on CPU ones."""
    if mesh is None:
        raise ValueError("msm_sharded needs a mesh")
    if len(scalars) == 0:
        raise ValueError("empty msm")
    if device_bases is None:
        device_bases = DeviceBases2(bases[0].curve, bases, device=mesh.devices[0])
    curve = device_bases.curve
    bf = TField(curve.base)
    if window is None:
        window = 16 if device_bases.x.device.type == "cuda" else 8
    c = msm3._effective_window(window, device_bases.x)
    sums = []
    for digits, fx, fy, fyneg, finf in shard_msm_inputs(scalars, device_bases, mesh, c):
        sorted_d, st = msm3._sortpack(digits, fx, fy, fyneg, finf)
        sums.append(msm3._msm3_sum(bf, sorted_d, st, c, "complete")[0])
    dev0 = mesh.devices[0]
    gathered = {k: torch.cat([s[k].to(dev0) for s in sums]) for k in KEYS}
    acc = _tree_reduce_points(bf, gathered)
    return _xyzz_row_to_affine(curve, {k: bf.from_mont(v) for k, v in acc.items()})


# ---------------------------------------------------------------------------
# sharded fold step (the drill of graft_entry.dryrun_multichip)
# ---------------------------------------------------------------------------


def _fold_elementwise_shard(tf: TField, az, bz, cz, e_vec, w1, w2, u: int, r: int):
    """One shard of the fold drill: T = Az*Bz - u*Cz - E, W' = W1 + r*W2,
    E' = E + r*T (K1), and the shard's partial sums
    s0 = sum lo^2, s_inf = sum (hi - lo)^2 over the halves of T."""
    u_b, r_b = tf.const_mont(u, cz), tf.const_mont(r, cz)
    t_vec = tf.sub(tf.sub(tf.mont_mul(az, bz), tf.mont_mul(u_b, cz)), e_vec)
    w_new = tf.add(w1, tf.mont_mul(r_b, w2))
    e_new = tf.add(e_vec, tf.mont_mul(r_b, t_vec))
    half = t_vec.shape[0] // 2
    lo, hi = t_vec[:half], t_vec[half:]
    dlt = tf.sub(hi, lo)
    parts = tf.mont_mul(torch.stack([lo, dlt]), torch.stack([lo, dlt]))
    return t_vec, w_new, e_new, _field_sum(tf, parts[0]), _field_sum(tf, parts[1])


def fold_elementwise_sharded(mesh: Mesh, tf: TField, az, bz, cz, e_vec, w1, w2,
                             u: int, r: int):
    """The elementwise half of the sharded fold step over (n, 16) Montgomery
    vectors split into D contiguous blocks, one per device. Returns (T, W',
    E') as lists of per-shard blocks and (s0, s_inf), the per-shard partial
    sums gathered on the first device and added there, (16,) each."""
    D = mesh.size
    n = az.shape[0]
    if n % D:
        raise ValueError(f"{n} entries do not split over {D} devices")
    n_loc = n // D
    outs = []
    for d, dev in enumerate(mesh.devices):
        blk = [v[d * n_loc : (d + 1) * n_loc].to(dev) for v in (az, bz, cz, e_vec, w1, w2)]
        outs.append(_fold_elementwise_shard(tf, *blk, u, r))
    dev0 = mesh.devices[0]
    s0 = _field_sum(tf, torch.stack([o[3].to(dev0) for o in outs]))
    sinf = _field_sum(tf, torch.stack([o[4].to(dev0) for o in outs]))
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs], s0, sinf


def run_sharded_fold_step(mesh: Mesh, field, n: int, seed: int = 7):
    """Drive the fold drill once on random data over `mesh`: the
    elementwise fold and its exact cross-shard sums, then the commitment of
    n random scalars to the doubling chain G, 2G, 4G, ... through
    msm_sharded. The values are drawn in the JAX package's order, so the
    returned commitment (an AffinePoint) is its commitment."""
    from nova_tpu_torch.curves.spec import AffinePoint

    rng = random.Random(seed)
    spec = field.spec if hasattr(field, "spec") else field
    tf = TField(spec)
    p = spec.p
    dev0 = mesh.devices[0]

    def vec():
        return [rng.randrange(p) for _ in range(n)]

    def pack(vals):
        return tf.to_mont(torch.from_numpy(tf.pack(vals)).to(dev0))

    az, bz, cz = pack(vec()), pack(vec()), pack(vec())
    e_vec, w1, w2 = pack(vec()), pack(vec()), pack(vec())
    u, r = rng.randrange(p), rng.randrange(p)
    scalars = vec()
    curve = _pick_curve_for_field(spec)
    bases, acc = [], AffinePoint.generator(curve)
    for _ in range(n):
        bases.append(acc)
        acc = acc.double()
    fold_elementwise_sharded(mesh, tf, az, bz, cz, e_vec, w1, w2, u, r)
    return msm_sharded(scalars, bases, mesh=mesh)


# ---------------------------------------------------------------------------
# sharded outer sumcheck (Spartan's cubic rounds, distributed)
# ---------------------------------------------------------------------------


def _strided_shards(tf: TField, tables, mesh: Mesh):
    """Tables of n values (HVecs or int lists) -> per-shard stacked
    Montgomery tensors (k, n/D, 16), shard d on mesh.devices[d] holding the
    indices = d mod D."""
    D = mesh.size
    std = np.stack([_std_limbs16(t) for t in tables])  # (k, n, 16)
    k, n, _ = std.shape
    strided = std.reshape(k, n // D, D, NUM_LIMBS)
    return [tf.to_mont(torch.from_numpy(np.ascontiguousarray(strided[:, :, d])).to(dev))
            for d, dev in enumerate(mesh.devices)]


def prove_cubic_with_three_inputs_sharded(field, claim: int, taus: Sequence[int],
                                          Az, Bz, Cz, transcript, mesh: Mesh):
    """Mesh-sharded SumcheckProof.prove_cubic_with_three_inputs (the Spartan
    outer sumcheck, src/spartan/sumcheck.rs:445-506): the tables split
    strided over the mesh, each round's three sums reduce exactly on the
    first device, binds stay on each shard, and the last log2(D) variables
    (the strided bits) finish on the host once one element per device
    remains. Transcript, proof, r and claims are bit-identical to the host
    prover's. Az/Bz/Cz are int lists or HVecs."""
    from nova_tpu_torch.spartan.polys import EqPolynomial
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    p = field.p
    D = mesh.size
    n = 1 << len(taus)
    if D & (D - 1) or n % D or n // D < 2:
        raise ValueError(f"{n} evaluations do not split over {D} devices (2 or more each)")
    tf = TField(field)
    dev0 = mesh.devices[0]
    eq = EqPolynomial.evals_hvec(field, [t % p for t in taus])
    shards = _strided_shards(tf, (eq, Az, Bz, Cz), mesh)

    r_out: List[int] = []
    polys = []
    claim_per_round = claim % p
    while shards[0].shape[1] > 1:
        parts = torch.stack([cubic_round_sums(tf, T).to(dev0) for T in shards], dim=1)
        evals = tf.unpack(tf.from_mont(_field_sum(tf, parts)))  # parts: (3, D, 16)
        r_i, claim_per_round = SumcheckProof._round(
            field, polys, transcript, claim_per_round, evals, True)
        r_out.append(r_i)
        shards = [bind_top(tf, r_i, T) for T in shards]

    # strided tail: one element per device, global index = device index
    tail = torch.cat([T.to(dev0) for T in shards], dim=1)  # (4, D, 16)
    E, A, B, C = (tf.unpack(tf.from_mont(t)) for t in tail)
    while len(A) >= 2:
        half = len(A) // 2
        e0 = c3 = em1 = 0
        for i in range(half):
            de, da = E[half + i] - E[i], A[half + i] - A[i]
            db, dc = B[half + i] - B[i], C[half + i] - C[i]
            e0 += E[i] * (A[i] * B[i] - C[i])
            c3 += de * da * db
            em1 += (E[i] - de) * ((A[i] - da) * (B[i] - db) - (C[i] - dc))
        r_i, claim_per_round = SumcheckProof._round(
            field, polys, transcript, claim_per_round, (e0 % p, c3 % p, em1 % p), True)
        r_out.append(r_i)
        E, A, B, C = ([(Z[i] + r_i * (Z[half + i] - Z[i])) % p for i in range(half)]
                      for Z in (E, A, B, C))
    return SumcheckProof(polys), r_out, [A[0], B[0], C[0]]


def _pick_curve_for_field(spec):
    """The registered curve whose base field is `spec`."""
    from nova_tpu_torch.curves.spec import bn254, grumpkin, pallas, secp256k1, secq256k1, vesta

    for c in (pallas, vesta, bn254, grumpkin, secp256k1, secq256k1):
        if c.base.p == spec.p:
            return c
    raise ValueError("no curve over this base field")
