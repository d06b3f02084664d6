"""Carry state across from the JAX package.

The JAX package keeps field vectors and bases as ``(N, 16)`` uint32 arrays
of 16-bit Montgomery limbs. These functions take those arrays as numpy
(``np.asarray`` of the JAX array) and build the port's objects on a given
device, so both packages compute on the same state. They take numpy only
and import nothing of the JAX package.
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
