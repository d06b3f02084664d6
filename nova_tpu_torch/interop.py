"""Carry state across from the JAX package.

The JAX package keeps field vectors and bases as ``(N, 16)`` uint32 arrays
of 16-bit Montgomery limbs. These functions take those arrays as numpy
(``np.asarray`` of the JAX array) and build the port's objects on a given
device, so both packages compute on the same state. They take numpy (and
ppsnark_keys the JAX package's key objects, read by attribute) and import
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from nova_tpu_torch._device import resolve
from nova_tpu_torch.fields.tfield import TField


def limbs(arr, device=None) -> torch.Tensor:
    """(..., 16) uint32 limb array -> int32 tensor (same bits)."""
    a = np.asarray(arr)
    if a.dtype != np.uint32 or a.shape[-1] != 16:
        raise ValueError(f"expected (..., 16) uint32 limbs, got {a.dtype} {a.shape}")
    if (a >> 16).any():
        raise ValueError("limbs must be below 2^16")
    return torch.from_numpy(a.astype(np.int32)).to(resolve(device))


def fvec(field, m, device=None):
    """An FVec's Montgomery limbs ``.m`` -> the port's FVec."""
    from nova_tpu_torch.ops.fvec import FVec

    tf = field if isinstance(field, TField) else TField(field)
    return FVec(tf, limbs(m, device))


def device_bases2(curve, x, y, inf, device=None):
    """A DeviceBases2's ``x``/``y`` (Montgomery rows) and ``inf`` flags ->
    the port's DeviceBases2."""
    from nova_tpu_torch.ops.msm2 import DeviceBases2

    dev = resolve(device)
    flags = torch.from_numpy(np.array(inf, dtype=bool)).to(dev)
    return DeviceBases2.from_tensors(curve, limbs(x, dev), limbs(y, dev), flags)


def set_fixed(db, c: int, n_pad: int, fx, fy, finf) -> None:
    """Install window-shifted bases ``(fx, fy, finf)`` computed by the JAX
    package (rows of window w at [w*n_pad, (w+1)*n_pad), all
    (255 + c - 1)//c + 1 windows) as `db`'s precompute for (c, n_pad)."""
    dev = db.x.device
    db.set_fixed(
        c, n_pad, limbs(fx, dev), limbs(fy, dev),
        torch.from_numpy(np.array(finf, dtype=bool)).to(dev),
    )


def r1cs_shape(field, num_cons: int, num_vars: int, num_io: int, mats: dict):
    """An R1CSShape from its dimensions and ``mats[name] = (data, indices,
    indptr)`` for name in "A", "B", "C": data an (nnz, 16) uint32 array of
    16-bit limbs of the standard-form entries, indices and indptr the CSR
    integer arrays. Built through R1CSShape.new, which checks the indices."""
    from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

    tf = TField(field)
    cols = num_vars + num_io + 1
    built = []
    for name in ("A", "B", "C"):
        data, indices, indptr = mats[name]
        d = np.asarray(data)
        if d.dtype != np.uint32 or (d.ndim == 2 and d.shape[1] != 16) or (d >> 16).any():
            raise ValueError(f"{name}: expected (nnz, 16) uint32 16-bit limbs")
        vals = tf.unpack(d.reshape(-1, 16)) if d.size else []
        built.append(SparseMatrix(
            field, vals, [int(i) for i in indices], [int(i) for i in indptr], cols
        ))
    return R1CSShape.new(field, num_cons, num_vars, num_io, *built)


def commitment_key(curve, rows, device=None):
    """A Pedersen CommitmentKey from (N + 1, 65) uint8 generator rows
    x[32] | y[32] | inf[1] (the key cache's row format), row 0 being the
    blinding generator h; its device MSMs run on `device`."""
    from nova_tpu_torch.provider.pedersen import CommitmentKey, gens_from_rows

    r = np.asarray(rows)
    if r.dtype != np.uint8 or r.ndim != 2 or r.shape[1] != 65 or r.shape[0] < 2:
        raise ValueError(f"expected (N + 1, 65) uint8 rows, got {r.dtype} {r.shape}")
    gens = gens_from_rows(curve, r)
    return CommitmentKey(curve, gens[1:], gens[0], device=resolve(device))


def kzg_commitment_key(rows, tau_H, device=None):
    """A HyperKZG (powers-of-tau) key over BN254: `rows` as for
    commitment_key (row 0 the blinding generator h, then tau^i * G), and
    `tau_H` the G2 point tau * H as ``((x0, x1), (y0, y1))`` ints. The key
    carries `tau_H` as a ptau-loaded key does."""
    from nova_tpu_torch.curves.pairing import G2Point
    from nova_tpu_torch.curves.spec import bn254

    (x0, x1), (y0, y1) = tau_H
    g2 = G2Point((int(x0), int(x1)), (int(y0), int(y1)))
    if not g2.is_on_curve():
        raise ValueError("tau_H is not on the G2 curve")
    ck = commitment_key(bn254, rows, device)
    ck._tau_H = g2
    return ck


def public_params(engine1, engine2, F_arity: int, shape1: dict, rows1,
                  shape2: dict, rows2, device=None, tau_H1=None):
    """The port's PublicParams from the JAX package's, through its own
    constructor: `shape1`/`shape2` are dicts of r1cs_shape's arguments
    (num_cons, num_vars, num_io, A, B, C) and `rows1`/`rows2` the key rows
    of commitment_key, primary first; both keys are put on `device`. With
    `tau_H1` the primary key is a HyperKZG key (kzg_commitment_key)."""
    from nova_tpu_torch.nova.ivc import PublicParams

    def shape(d, engine):
        return r1cs_shape(engine.scalar, d["num_cons"], d["num_vars"], d["num_io"], d)

    ck1 = (commitment_key(engine1.curve, rows1, device) if tau_H1 is None
           else kzg_commitment_key(rows1, tau_H1, device))
    return PublicParams(
        engine1, engine2, F_arity,
        shape(shape1, engine1), ck1,
        shape(shape2, engine2), commitment_key(engine2.curve, rows2, device),
    )


def neutron_public_params(engine1, engine2, F_arity: int, shape: dict, rows, device=None):
    """The port's NeutronNova PublicParams from the JAX package's, through
    its own constructor: `shape` is a dict of r1cs_shape's arguments for the
    structure's (padded) shape, `rows` the key rows of commitment_key; the
    key is put on `device`."""
    from nova_tpu_torch.neutron import Structure
    from nova_tpu_torch.neutron.ivc import PublicParams

    S = r1cs_shape(engine1.scalar, shape["num_cons"], shape["num_vars"], shape["num_io"], shape)
    ck = commitment_key(engine1.curve, rows, device)
    return PublicParams(engine1, engine2, F_arity, ck, Structure(S))


_SPARK_FIELDS = ("row", "col", "val_A", "val_B", "val_C", "ts_row", "ts_col")


def _point_rows(points) -> np.ndarray:
    """(N, 65) uint8 rows x[32] | y[32] | inf[1] of affine points given by
    their ``x``, ``y`` and ``infinity`` attributes."""
    rows = np.zeros((len(points), 65), dtype=np.uint8)
    for i, g in enumerate(points):
        if g.infinity:
            rows[i, 64] = 1
            continue
        rows[i, :32] = np.frombuffer(int(g.x).to_bytes(32, "little"), dtype=np.uint8)
        rows[i, 32:64] = np.frombuffer(int(g.y).to_bytes(32, "little"), dtype=np.uint8)
    return rows


def ppsnark_keys(jax_pk, jax_vk, device=None):
    """The port's ppsnark (PPProverKey, PPVerifierKey) from the JAX
    package's, read by attribute: the engine by its name, the spark vectors
    as lists, the spark commitments as affine points, and the evaluation
    engine (IPA, HyperKZG or Mercury, by its module's name) with its keys:
    IPA's commitment keys through commitment_key, HyperKZG's verifier key
    (G, H, tau_H) as points; the keys' device MSMs run on `device`."""
    import importlib

    from nova_tpu_torch.curves.pairing import G2Point
    from nova_tpu_torch.curves.spec import AffinePoint
    from nova_tpu_torch.provider.engines import Engine
    from nova_tpu_torch.provider.pedersen import Commitment
    from nova_tpu_torch.spartan import ppsnark

    engine = Engine._registry[jax_vk.engine.name]
    curve = engine.curve
    ee = importlib.import_module(
        "nova_tpu_torch.provider." + jax_vk.ee.__module__.rsplit(".", 1)[-1]
    ).EvaluationEngine

    def key(ck):
        return commitment_key(curve, _point_rows([ck.h] + list(ck.ck)), device)

    def g2(pt):
        return G2Point(tuple(int(v) for v in pt.x), tuple(int(v) for v in pt.y))

    kind = type(jax_vk.ee_vk).__name__
    if kind == "IPAVerifierKey":
        from nova_tpu_torch.provider.ipa import IPAProverKey, IPAVerifierKey

        ck_s = key(jax_pk.ee_pk.ck_s)
        ee_pk, ee_vk = IPAProverKey(ck_s), IPAVerifierKey(key(jax_vk.ee_vk.ck_v), ck_s)
    elif kind == "HyperKZGVerifierKey":
        from nova_tpu_torch.provider.hyperkzg import HyperKZGProverKey, HyperKZGVerifierKey

        G = jax_vk.ee_vk.G
        ee_pk = HyperKZGProverKey()
        ee_vk = HyperKZGVerifierKey(AffinePoint(curve, int(G.x), int(G.y), bool(G.infinity)),
                                    g2(jax_vk.ee_vk.H), g2(jax_vk.ee_vk.tau_H))
    else:
        raise ValueError(f"unknown evaluation-engine key {kind}")

    sc = jax_vk.S_comm
    comms = [Commitment(AffinePoint(curve, int(c.point.x), int(c.point.y),
                                    bool(c.point.infinity)))
             for c in (getattr(sc, "comm_" + f) for f in _SPARK_FIELDS)]
    S_comm = ppsnark.R1CSShapeSparkCommitment(sc.N, *comms)
    jr = jax_pk.S_repr
    S_repr = ppsnark.R1CSShapeSparkRepr.from_vectors(
        engine.scalar, jr.N, *(getattr(jr, f) for f in _SPARK_FIELDS))
    vk = ppsnark.PPVerifierKey(engine, jax_vk.num_cons, jax_vk.num_vars, S_comm, ee_vk, ee)
    pk = ppsnark.PPProverKey(ee_pk, S_repr, S_comm, jax_pk.vk_digest, ee)
    return pk, vk
