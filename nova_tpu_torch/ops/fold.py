"""Device folds and the device-resident cross-term (port of
``nova_tpu/ops/fold.py``; reference: src/r1cs/mod.rs:533-619, 989-1052).

``commit_T_device`` computes T = Az o Bz - u*Cz - E on the folded
Z = W1 + W2 || u || X1 + X2 with one SpMV per matrix (the Mova single-SpMV
trick) from Montgomery device inputs, and returns T as an FVec on the
device. ``r1cs`` routes the cross-term of every shape of at least
FOLD_DEVICE_THRESHOLD rows here, square or not, after ``witness_on_device``
has put the incoming witness on the card once for the whole fold.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from nova_tpu_torch._device import resolve
from nova_tpu_torch.fields.spec import FieldSpec
from nova_tpu_torch.fields.tfield import TField


def fold_witness_device(field: FieldSpec, W1: Sequence[int], W2: Sequence[int],
                        E1: Sequence[int], T: Sequence[int], r: int,
                        device=None) -> Tuple[List[int], List[int]]:
    """W1 + r*W2 and E1 + r*T of int lists, computed on `device`."""
    from nova_tpu_torch.ops.fvec import FVec

    tf = TField(field)
    dev = resolve(device)
    W = FVec.from_ints(tf, W1, dev).axpy(r, FVec.from_ints(tf, W2, dev))
    E = FVec.from_ints(tf, E1, dev).axpy(r, FVec.from_ints(tf, T, dev))
    return W.to_ints(), E.to_ints()


def fold_device(W1, device=None) -> torch.device:
    """The device a fold into the running witness W1 runs on: that of W1.W
    when it is an FVec, else `device` (CUDA unless given)."""
    from nova_tpu_torch.ops.fvec import FVec

    return W1.W.device if isinstance(W1.W, FVec) else resolve(device)


def witness_on_device(field: FieldSpec, W, device):
    """W (an R1CSWitness or a RelaxedR1CSWitness) with its vectors as FVecs
    on `device`; a vector that is an FVec already is kept as it is."""
    from nova_tpu_torch.ops.fvec import FVec

    tf = TField(field)
    vecs = {"W": FVec.coerce(tf, W.W, device)}
    if hasattr(W, "E"):
        vecs["E"] = FVec.coerce(tf, W.E, device)
    return dataclasses.replace(W, **vecs)


def commit_T_device(shape, U1, W1, U2, W2, relaxed: bool, device=None):
    """Device-resident cross-term for plain (U2.u == 1, E2 == 0) or relaxed
    folding. Returns T as an FVec on `device` (CUDA unless given, or the
    device of W1.W when it is an FVec); the caller commits to it with the
    Montgomery-scalar MSM."""
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.ops.spmv import get_device_csr, spmv_m

    tf = TField(shape.field)
    p = shape.field.p
    dev = fold_device(W1, device)
    W1v = FVec.coerce(tf, W1.W, dev)
    W2v = FVec.coerce(tf, W2.W, dev)
    E1v = FVec.coerce(tf, W1.E, dev)
    if relaxed:
        em = E1v.add(FVec.coerce(tf, W2.E, dev)).m
        u = (U1.u + U2.u) % p
    else:
        em = E1v.m
        u = (U1.u + 1) % p
    tail = [u] + [(a + b) % p for a, b in zip(U1.X, U2.X)]
    tailm = tf.to_mont(torch.from_numpy(tf.pack(tail)).to(dev))
    zm = torch.cat([tf.add(W1v.m, W2v.m), tailm])
    az, bz, cz = (
        spmv_m(tf, _nonempty(get_device_csr(shape, w, dev)), zm) for w in "ABC"
    )
    um = tf.const_mont(u, cz)
    t = tf.sub(tf.sub(tf.mont_mul(az, bz), tf.mont_mul(um, cz)), em)
    return FVec(tf, t)


def _nonempty(csr):
    assert not csr.empty, "commit_T_device requires non-empty matrices"
    return csr
