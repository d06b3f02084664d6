"""XYZZ point vectors on tensors (port of ``nova_tpu/curves/jpoints.py``).

Points in extended-Jacobian XYZZ coordinates (X, Y, ZZ, ZZZ), ZZ = Z^2,
ZZZ = Z^3, affine = (X/ZZ, Y/ZZZ); the identity has ZZ = 0. A point
VECTOR is a dict {x, y, zz, zzz} of (..., 16) int32 Montgomery limb
tensors. ``xyzz_add`` is kernel K2 and ``xyzz_double`` kernel K3 on CUDA
tensors; on CPU tensors both run the plain limb formulas, which follow the
reference's multiply order, so XYZZ outputs compare bitwise.
"""

from __future__ import annotations

import torch

from nova_tpu_torch.fields import kernels
from nova_tpu_torch.fields.tfield import TField

KEYS = kernels.KEYS


def xyzz_zero(tf: TField, shape_like) -> dict:
    """Identity: (1, 1, 0, 0)."""
    one = tf.one_mont(shape_like)
    zero = torch.zeros_like(shape_like)
    return {"x": one, "y": one, "zz": zero, "zzz": zero}


def xyzz_is_zero(tf: TField, p: dict):
    return tf.is_zero(p["zz"])


def xyzz_select(tf: TField, cond, a: dict, b: dict) -> dict:
    return {k: tf.select(cond, a[k], b[k]) for k in KEYS}


def xyzz_from_affine(tf: TField, x, y, inf) -> dict:
    """Affine (x, y, inf) -> XYZZ with ZZ = ZZZ = 1 (identity when inf)."""
    one = tf.one_mont(x)
    p = {"x": x, "y": y, "zz": one, "zzz": one}
    return xyzz_select(tf, ~inf, p, xyzz_zero(tf, x))


def xyzz_double(tf: TField, p: dict, times: int = 1) -> dict:
    """dbl-2008-s-1 (a = 0), masked for identity, `times` times in one
    launch (kernel K3)."""
    return kernels.xyzz_double(tf, p, times)


def xyzz_add(tf: TField, p: dict, q: dict) -> dict:
    """Complete XYZZ + XYZZ (add-2008-s), masked for either operand being
    the identity, doubling and inverses (kernel K2)."""
    return kernels.xyzz_add(tf, p, q)
