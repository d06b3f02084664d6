"""CSR sparse-matrix x dense-vector products on the device (port of
``nova_tpu/ops/spmv.py``; reference: src/r1cs/sparse.rs:200-229).

A product gathers z by column index, Montgomery-multiplies by the CSR data
(kernel K1 on CUDA tensors), sums each row's 16-bit limb columns in int64
with ``index_add_`` (the reference's ``segment_sum``, XLA glue outside any
Pallas kernel there) and reduces the wide sums once (``reduce_wide``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nova_tpu_torch import profiling
from nova_tpu_torch._device import resolve
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField


class DeviceCSR:
    """A CSR matrix marshalled to `device` (Montgomery data)."""

    def __init__(self, tf: TField, matrix, device):
        self.tf = tf
        self.rows = matrix.rows
        self.empty = matrix.nnz == 0
        if self.empty:
            return
        indptr = np.asarray(matrix.indptr, dtype=np.int64)
        # a row's limb sums stay below 2^31, reduce_wide's input bound
        assert int(np.max(np.diff(indptr))) < (1 << 15), "row too dense for limb sums"
        self.data = tf.to_mont(torch.from_numpy(tf.pack(matrix.data)).to(device))
        self.indices = torch.from_numpy(np.asarray(matrix.indices, dtype=np.int64)).to(device)
        row_ids = np.repeat(np.arange(self.rows, dtype=np.int64), np.diff(indptr))
        self.row_ids = torch.from_numpy(row_ids).to(device)


def spmv_m(tf: TField, csr: DeviceCSR, zm):
    """M z on Montgomery limbs: (rows, 16) int32 canonical Montgomery rows."""
    prods = tf.mont_mul(zm[csr.indices], csr.data).long()
    sums = torch.zeros((csr.rows, NUM_LIMBS), dtype=torch.int64, device=zm.device)
    sums.index_add_(0, csr.row_ids, prods)
    return tf.reduce_wide([sums[:, i] for i in range(NUM_LIMBS)])


def get_device_csr(shape, which: str, device) -> DeviceCSR:
    """The shape's matrix `which` ("A", "B" or "C") on `device`, cached on
    the shape."""
    cache = shape.__dict__.setdefault("_device_csr", {})
    key = (which, str(device))
    if key not in cache:
        cache[key] = DeviceCSR(TField(shape.field), getattr(shape, which), device)
    return cache[key]


def multiply_vec_device(shape, z: Sequence[int], device=None):
    """Az, Bz, Cz for a shape, computed on `device` (CUDA unless given);
    returns three int lists of num_cons entries."""
    with profiling.phase("spmv"):
        dev = resolve(device)
        tf = TField(shape.field)
        zm = tf.to_mont(torch.from_numpy(tf.pack([int(x) for x in z])).to(dev))
        outs = []
        for which in ("A", "B", "C"):
            csr = get_device_csr(shape, which, dev)
            if csr.empty:
                outs.append([0] * shape.num_cons)
                continue
            vals = tf.unpack(tf.from_mont(spmv_m(tf, csr, zm)))
            vals += [0] * (shape.num_cons - len(vals))
            outs.append(vals)
        return tuple(outs)
