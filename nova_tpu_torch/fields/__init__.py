"""Prime-field arithmetic: exact host ops on Python ints (``spec``) and the
16-bit-limb Montgomery engine on ``(N, 16)`` int32 tensors (``tfield``)."""

from nova_tpu_torch.fields.spec import (
    FieldSpec,
    pallas_base,
    pallas_scalar,
    vesta_base,
    vesta_scalar,
    bn254_base,
    bn254_scalar,
    grumpkin_base,
    grumpkin_scalar,
    secp_base,
    secp_scalar,
    secq_base,
    secq_scalar,
)

__all__ = [
    "FieldSpec",
    "pallas_base",
    "pallas_scalar",
    "vesta_base",
    "vesta_scalar",
    "bn254_base",
    "bn254_scalar",
    "grumpkin_base",
    "grumpkin_scalar",
    "secp_base",
    "secp_scalar",
    "secq_base",
    "secq_scalar",
]
