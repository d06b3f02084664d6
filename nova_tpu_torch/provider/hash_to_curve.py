"""Hash-to-curve for generator derivation (`from_label`).

The reference lifts 32-byte Shake256 blocks to the curve with
halo2curves' `hash_to_curve("from_uniform_bytes")`
(Nova's src/provider/traits.rs:249-293).  That map is, per the
halo2curves/pasta_curves lineage:

  u0, u1 = hash_to_field(msg)          # expand_message_xmd over BLAKE2b-512,
                                       # DST = "{prefix}-{curve_id}_XMD:BLAKE2b_{METHOD}_RO_"
  SSWU curves (pallas, vesta, secp256k1):
      q_i = simplified-SWU(u_i) on a 3-isogenous curve E'
      out = iso_map(q0 + q1)           # degree-3 isogeny E' -> E
  SVDW curves (bn254, grumpkin, secq256k1):
      out = svdw(u0) + svdw(u1)        # Shallue–van de Woestijne map

Both maps follow RFC 9380 straight-line algorithms (§6.6.1 SSWU,
§6.6.2 SVDW); every constant below (iso curve, isogeny coefficients,
Z) is DERIVED, not transcribed — see
tools/derive_hash_to_curve_constants.py, which reproduces the published
`find_iso`/`find_z_*` searches from the hash-to-curve draft appendices
and verifies dual(phi(P)) == [3]P numerically.  The derived iso-curve
constants match the published ones exactly (iso-pallas/iso-vesta A', B'
per the Zcash protocol spec §5.4.9.8; iso-secp256k1 A'=0x3f8731ab...,
B'=1771 per RFC 9380 §E.1), which also pins the kernel choice.

Residual bit-exactness risk (documented, resolved by golden vectors the
moment tools/gen_golden_vectors.rs runs against the reference): the
halo2curves CURVE_ID strings for bn254/grumpkin/secq256k1 in the DST are
taken from the halo2curves docs, not verified against its source (zero
egress here).
"""

from __future__ import annotations

import hashlib
from typing import Tuple

from nova_tpu_torch.curves.spec import AffinePoint, CurveSpec

# ---------------------------------------------------------------------------
# expand_message_xmd over BLAKE2b-512 (r_in_bytes=128, b_in_bytes=64),
# exactly the pasta_curves/halo2curves hash_to_field construction.


def expand_message_xmd_blake2b(msg: bytes, dst: bytes) -> Tuple[bytes, bytes]:
    """Two 64-byte blocks (ell = 2) of RFC 9380 expand_message_xmd with
    H = BLAKE2b-512 (block size 128)."""
    assert len(dst) < 256
    dst_prime = dst + bytes([len(dst)])
    h = hashlib.blake2b
    b0 = h(b"\x00" * 128 + msg + b"\x00\x80\x00" + dst_prime,
           digest_size=64).digest()
    b1 = h(b0 + b"\x01" + dst_prime, digest_size=64).digest()
    b2 = h(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime,
           digest_size=64).digest()
    return b1, b2


def hash_to_field(curve: CurveSpec, method: bytes, curve_id: bytes,
                  domain_prefix: bytes, msg: bytes) -> Tuple[int, int]:
    """u_i = OS2IP(b_i) mod p — halo2curves reverses each 64-byte digest and
    parses little-endian, i.e. big-endian interpretation of the digest."""
    dst = domain_prefix + b"-" + curve_id + b"_XMD:BLAKE2b_" + method + b"_RO_"
    b1, b2 = expand_message_xmd_blake2b(msg, dst)
    p = curve.base.p
    return int.from_bytes(b1, "big") % p, int.from_bytes(b2, "big") % p


# ---------------------------------------------------------------------------
# map_to_curve building blocks (host Python ints; from_label is a one-time
# setup cost and the result is cached on disk by the commitment engine).


def _sgn0(x: int) -> int:
    return x & 1


def _ec_add(p: int, a: int, P, Q):
    """Affine add on y^2 = x^3 + a x + b; None is the identity."""
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1 % p, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow((x2 - x1) % p, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return x3, y3


def sswu_map(curve: CurveSpec, u: int, cfg: dict) -> Tuple[int, int]:
    """RFC 9380 §6.6.2 simplified SWU on the isogenous curve E'(A', B')."""
    F = curve.base
    p = F.p
    A, B, Z = cfg["iso_a"], cfg["iso_b"], cfg["z"]
    u2 = u * u % p
    tv1 = (Z * Z % p * (u2 * u2 % p) + Z * u2) % p
    if tv1 == 0:
        x1 = B * pow(Z * A % p, p - 2, p) % p
    else:
        x1 = (p - B) * pow(A, p - 2, p) % p * (1 + pow(tv1, p - 2, p)) % p
    gx1 = (x1 * x1 % p * x1 + A * x1 + B) % p
    y = F.sqrt(gx1)
    if y is None:
        x1 = Z * u2 % p * x1 % p
        gx1 = (x1 * x1 % p * x1 + A * x1 + B) % p
        y = F.sqrt(gx1)
        assert y is not None
    if _sgn0(u) != _sgn0(y):
        y = p - y
    return x1, y


def iso_map(curve: CurveSpec, P, cfg: dict):
    """Degree-3 isogeny E' -> E in the 13-constant rational-map form."""
    if P is None:
        return None
    p = curve.base.p
    x, y = P

    def horner(coeffs):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    xd = horner(cfg["x_den"])
    if xd == 0:
        return None  # kernel of the isogeny -> point at infinity
    yd = horner(cfg["y_den"])
    X = horner(cfg["x_num"]) * pow(xd, p - 2, p) % p
    Y = y * horner(cfg["y_num"]) % p * pow(yd, p - 2, p) % p
    return X, Y


def svdw_map(curve: CurveSpec, u: int, cfg: dict) -> Tuple[int, int]:
    """RFC 9380 §6.6.1 Shallue–van de Woestijne, straight-line version."""
    F = curve.base
    p = F.p
    A, B = 0, curve.b % p
    Z, c1, c2, c3, c4 = cfg["z"], cfg["c1"], cfg["c2"], cfg["c3"], cfg["c4"]

    def g(x):
        return (x * x % p * x + A * x + B) % p

    def inv0(x):
        return 0 if x % p == 0 else pow(x, p - 2, p)

    tv1 = u * u % p * c1 % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    tv3 = inv0(tv1 * tv2 % p)
    tv4 = u * tv1 % p * tv3 % p * c3 % p
    x1 = (c2 - tv4) % p
    x2 = (c2 + tv4) % p
    x3 = (tv2 * tv2 % p * tv3 % p) ** 2 % p * c4 % p
    x3 = (x3 + Z) % p
    gx1, gx2 = g(x1), g(x2)
    if F.sqrt(gx1) is not None:
        x, gx = x1, gx1
    elif F.sqrt(gx2) is not None:
        x, gx = x2, gx2
    else:
        x, gx = x3, g(x3)
    y = F.sqrt(gx)
    assert y is not None
    if _sgn0(u) != _sgn0(y):
        y = p - y
    return x, y


# ---------------------------------------------------------------------------
# Derived constants — output of tools/derive_hash_to_curve_constants.py.

HASH_TO_CURVE_CONSTANTS = {
    'pallas': {
        'curve_id': 'pallas',
        'method': 'sswu',
        'iso_a': 0x18354a2eb0ea8c9c49be2d7258370742b74134581a27a59f92bb4b0b657a014b,
        'iso_b': 0x4f1,
        'z': 0x40000000000000000000000000000000224698fc094cf91b992d30ecfffffff4,
        'x_num': [0x1c71c71c71c71c71c71c71c71c71c71c8102eea8e7b06eb6eebec06955555580, 0x17329b9ec525375398c7d7ac3d98fd13380af066cfeb6d690eb64faef37ea4f7, 0x3509afd51872d88e267c7ffa51cf412a0f93b82ee4b994958cf863b02814fb76, 0xe38e38e38e38e38e38e38e38e38e38e4081775473d8375b775f6034aaaaaaab],
        'x_den': [0x325669becaecd5d11d13bf2a7f22b105b4abf9fb9a1fc81c2aa3af1eae5b6604, 0x1d572e7ddc099cff5a607fcce0494a799c434ac1c96b6980c47f2ab668bcd71f, 0x1],
        'y_num': [0x25ed097b425ed097b425ed097b425ed0ac03e8e134eb3e493e53ab371c71c4f, 0x3fb98ff0d2ddcadd303216cce1db9ff11765e924f745937802e2be87d225b234, 0x1a84d7ea8c396c47133e3ffd28e7a09507c9dc17725cca4ac67c31d8140a7dbb, 0x1a12f684bda12f684bda12f684bda12f7642b01ad461bad25ad985b5e38e38e4],
        'y_den': [0x40000000000000000000000000000000224698fc094cf91b992d30ecfffffde5, 0x17033d3c60c68173573b3d7f7d681310d976bbfabbc5661d4d90ab820b12320a, 0xc02c5bcca0e6b7f0790bfb3506defb65941a3a4a97aa1b35a28279b1d1b42ae, 0x1],
    },
    'vesta': {
        'curve_id': 'vesta',
        'method': 'sswu',
        'iso_a': 0x267f9b2ee592271a81639c4d96f787739673928c7d01b212c515ad7242eaa6b1,
        'iso_b': 0x4f1,
        'z': 0x40000000000000000000000000000000224698fc0994a8dd8c46eb20fffffff4,
        'x_num': [0x31c71c71c71c71c71c71c71c71c71c71e1c521a795ac8356fb539a6f0000002b, 0x18760c7f7a9ad20ded7ee4a9cdf78f8fd59d03d23b39cb11aeac67bbeb586a3d, 0x1d935247b4473d17acecf10f5f7c09a2216b8861ec72bd5d8b95c6aaf703bcc5, 0x38e38e38e38e38e38e38e38e38e38e390205dd51cfa0961a43cd42c800000001],
        'x_den': [0x14735171ee5427780c621de8b91c242a30cd6d53df49d235f169c187d2533465, 0xa2de485568125d51454798a5b5c56b2a3ad678129b604d3b7284f7eaf21a2e9, 0x1],
        'y_num': [0x1ed097b425ed097b425ed097b425ed098bc32d36fb21a6a38f64842c55555533, 0x19b0d87e16e2578866d1466e9de10e6497a3ca5c24e9ea634986913ab4443034, 0x2ec9a923da239e8bd6767887afbe04d121d910aefb03b31d8bee58e5fb81de63, 0x12f684bda12f684bda12f684bda12f685601f4709a8adcb36bef1642aaaaaaab],
        'y_den': [0x40000000000000000000000000000000224698fc0994a8dd8c46eb20fffffde5, 0x3d59f455cafc7668252659ba2b546c7e926847fb9ddd76a1d43d449776f99d2f, 0x2f44d6c801c1b8bf9e7eb64f890a820c06a767bfc35b5bac58dfecce86b2745e, 0x1],
    },
    'secp256k1': {
        'curve_id': 'secp256k1',
        'method': 'sswu',
        'iso_a': 0x3f8731abdd661adca08a5558f0f5d272e953d363cb6f0e5d405447c01a444533,
        'iso_b': 0x6eb,
        'z': 0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffefffffc24,
        'x_num': [0x8e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38daaaaa8c7, 0x7d3d4c80bc321d5b9f315cea7fd44c5d595d2fc0bf63b92dfff1044f17c6581, 0x534c328d23f234e6e2a413deca25caece4506144037c40314ecbd0b53d9dd262, 0x8e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38e38daaaaa88c],
        'x_den': [0xd35771193d94918a9ca34ccbb7b640dd86cd409542f8487d9fe6b745781eb49b, 0xedadc6f64383dc1df7c4b2d51b54225406d36b641f5e41bbc52a56612a8c6d14, 0x1],
        'y_num': [0x4bda12f684bda12f684bda12f684bda12f684bda12f684bda12f684b8e38e23c, 0xc75e0c32d5cb7c0fa9d0a54b12a0a6d5647ab046d686da6fdffc90fc201d71a3, 0x29a6194691f91a73715209ef6512e576722830a201be2018a765e85a9ecee931, 0x2f684bda12f684bda12f684bda12f684bda12f684bda12f684bda12f38e38d84],
        'y_den': [0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffefffff93b, 0x7a06534bb8bdb49fd5e9e6632722c2989467c1bfc8e8d978dfb425d2685c2573, 0x6484aa716545ca2cf3a70c3fa8fe337e0a3d21162f0d6299a7bf8192bfd2a76f, 0x1],
    },
    'bn254': {
        'curve_id': 'bn256_g1',
        'method': 'svdw',
        'z': 0x1,
        'c1': 0x4,
        'c2': 0x183227397098d014dc2822db40c0ac2ecbc0b548b438e5469e10460b6c3e7ea3,
        'c3': 0x16789af3a83522eb353c98fc6b36d713d5d8d1cc5dffffffa,
        'c4': 0x10216f7ba065e00de81ac1e7808072c9dd2b2385cd7b438469602eb24829a9bd,
    },
    'grumpkin': {
        'curve_id': 'grumpkin_g1',
        'method': 'svdw',
        'z': 0x1,
        'c1': 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593effffff1,
        'c2': 0x183227397098d014dc2822db40c0ac2e9419f4243cdcb848a1f0fac9f8000000,
        'c3': 0x2cf135e7506a45d66a7931f8d66dae274453478a4c627115c,
        'c4': 0x2042def740cbc01bd03583cf0100e59370229adafbd0f5b62d414e62a0000016,
    },
    'secq256k1': {
        'curve_id': 'secq256k1',
        'method': 'svdw',
        'z': 0x1,
        'c1': 0x8,
        'c2': 0x7fffffffffffffffffffffffffffffff5d576e7357a4501ddfe92f46681b20a0,
        'c3': 0xf6c80d02c694c7099cc633ea182d519bd1f4a17dab16878fd03dd026d2323162,
        'c4': 0xaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa9d1c9e899ca306ad27fe1945de0242b76,
    },
}



def hash_to_curve(curve: CurveSpec, domain_prefix: bytes,
                  msg: bytes) -> AffinePoint:
    """halo2curves `hash_to_curve(domain_prefix)(msg)` equivalent."""
    cfg = HASH_TO_CURVE_CONSTANTS[curve.name]
    p = curve.base.p
    u0, u1 = hash_to_field(curve, cfg["method"].upper().encode(),
                           cfg["curve_id"].encode(), domain_prefix, msg)
    if cfg["method"] == "sswu":
        q0 = sswu_map(curve, u0, cfg)
        q1 = sswu_map(curve, u1, cfg)
        r = _ec_add(p, cfg["iso_a"], q0, q1)
        out = iso_map(curve, r, cfg)
    else:
        q0 = svdw_map(curve, u0, cfg)
        q1 = svdw_map(curve, u1, cfg)
        out = _ec_add(p, 0, q0, q1)
    if out is None:
        return AffinePoint.identity(curve)
    pt = AffinePoint(curve, out[0], out[1])
    assert pt.is_on_curve()
    return pt
