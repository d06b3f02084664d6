"""Elliptic curve groups: three 2-cycles of a = 0 short-Weierstrass curves.

Host points (exact Python ints, :mod:`nova_tpu_torch.curves.spec`) and the
tensor XYZZ point ops (:mod:`nova_tpu_torch.curves.points`)."""

from nova_tpu_torch.curves.spec import (
    CurveSpec,
    AffinePoint,
    pallas,
    vesta,
    bn254,
    grumpkin,
    secp256k1,
    secq256k1,
)

__all__ = [
    "CurveSpec",
    "AffinePoint",
    "pallas",
    "vesta",
    "bn254",
    "grumpkin",
    "secp256k1",
    "secq256k1",
]
