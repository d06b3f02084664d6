"""Pedersen generators derived again from their label: SHAKE-256 of the
label read as 32-byte blocks, each lifted to the curve by the
halo2curves-style hash_to_curve("from_uniform_bytes") map (RFC 9380:
expand_message_xmd over BLAKE2b-512, then simplified SWU through a 3-isogeny
on Pallas and Vesta, Shallue-van de Woestijne on BN254 and Grumpkin).

The constants are those of the published maps (iso-Pallas and iso-Vesta
from the Zcash protocol specification, section 5.4.9.8; SvdW constants from
RFC 9380, appendix F.1). Derived keys are cached as (n, 65) uint8 rows
x[32] | y[32] | identity[1], little-endian, under the benchmark's own cache
directory, and a longer cached key serves a shorter one."""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import List

import numpy as np

from pbref.curves import CURVES, Point, add, sqrt

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_cache", "ref")

MAPS = {
    "pallas": {
        "curve_id": b"pallas", "method": b"SSWU",
        "iso_a": 0x18354a2eb0ea8c9c49be2d7258370742b74134581a27a59f92bb4b0b657a014b,
        "iso_b": 0x4f1,
        "z": 0x40000000000000000000000000000000224698fc094cf91b992d30ecfffffff4,
        "x_num": [0x1c71c71c71c71c71c71c71c71c71c71c8102eea8e7b06eb6eebec06955555580, 0x17329b9ec525375398c7d7ac3d98fd13380af066cfeb6d690eb64faef37ea4f7, 0x3509afd51872d88e267c7ffa51cf412a0f93b82ee4b994958cf863b02814fb76, 0xe38e38e38e38e38e38e38e38e38e38e4081775473d8375b775f6034aaaaaaab],
        "x_den": [0x325669becaecd5d11d13bf2a7f22b105b4abf9fb9a1fc81c2aa3af1eae5b6604, 0x1d572e7ddc099cff5a607fcce0494a799c434ac1c96b6980c47f2ab668bcd71f, 0x1],
        "y_num": [0x25ed097b425ed097b425ed097b425ed0ac03e8e134eb3e493e53ab371c71c4f, 0x3fb98ff0d2ddcadd303216cce1db9ff11765e924f745937802e2be87d225b234, 0x1a84d7ea8c396c47133e3ffd28e7a09507c9dc17725cca4ac67c31d8140a7dbb, 0x1a12f684bda12f684bda12f684bda12f7642b01ad461bad25ad985b5e38e38e4],
        "y_den": [0x40000000000000000000000000000000224698fc094cf91b992d30ecfffffde5, 0x17033d3c60c68173573b3d7f7d681310d976bbfabbc5661d4d90ab820b12320a, 0xc02c5bcca0e6b7f0790bfb3506defb65941a3a4a97aa1b35a28279b1d1b42ae, 0x1],
    },
    "vesta": {
        "curve_id": b"vesta", "method": b"SSWU",
        "iso_a": 0x267f9b2ee592271a81639c4d96f787739673928c7d01b212c515ad7242eaa6b1,
        "iso_b": 0x4f1,
        "z": 0x40000000000000000000000000000000224698fc0994a8dd8c46eb20fffffff4,
        "x_num": [0x31c71c71c71c71c71c71c71c71c71c71e1c521a795ac8356fb539a6f0000002b, 0x18760c7f7a9ad20ded7ee4a9cdf78f8fd59d03d23b39cb11aeac67bbeb586a3d, 0x1d935247b4473d17acecf10f5f7c09a2216b8861ec72bd5d8b95c6aaf703bcc5, 0x38e38e38e38e38e38e38e38e38e38e390205dd51cfa0961a43cd42c800000001],
        "x_den": [0x14735171ee5427780c621de8b91c242a30cd6d53df49d235f169c187d2533465, 0xa2de485568125d51454798a5b5c56b2a3ad678129b604d3b7284f7eaf21a2e9, 0x1],
        "y_num": [0x1ed097b425ed097b425ed097b425ed098bc32d36fb21a6a38f64842c55555533, 0x19b0d87e16e2578866d1466e9de10e6497a3ca5c24e9ea634986913ab4443034, 0x2ec9a923da239e8bd6767887afbe04d121d910aefb03b31d8bee58e5fb81de63, 0x12f684bda12f684bda12f684bda12f685601f4709a8adcb36bef1642aaaaaaab],
        "y_den": [0x40000000000000000000000000000000224698fc0994a8dd8c46eb20fffffde5, 0x3d59f455cafc7668252659ba2b546c7e926847fb9ddd76a1d43d449776f99d2f, 0x2f44d6c801c1b8bf9e7eb64f890a820c06a767bfc35b5bac58dfecce86b2745e, 0x1],
    },
    "bn254": {
        "curve_id": b"bn256_g1", "method": b"SVDW",
        "z": 0x1, "c1": 0x4,
        "c2": 0x183227397098d014dc2822db40c0ac2ecbc0b548b438e5469e10460b6c3e7ea3,
        "c3": 0x16789af3a83522eb353c98fc6b36d713d5d8d1cc5dffffffa,
        "c4": 0x10216f7ba065e00de81ac1e7808072c9dd2b2385cd7b438469602eb24829a9bd,
    },
    "grumpkin": {
        "curve_id": b"grumpkin_g1", "method": b"SVDW",
        "z": 0x1,
        "c1": 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593effffff1,
        "c2": 0x183227397098d014dc2822db40c0ac2e9419f4243cdcb848a1f0fac9f8000000,
        "c3": 0x2cf135e7506a45d66a7931f8d66dae274453478a4c627115c,
        "c4": 0x2042def740cbc01bd03583cf0100e59370229adafbd0f5b62d414e62a0000016,
    },
}


def _hash_to_field(p: int, cfg: dict, msg: bytes):
    dst = b"from_uniform_bytes-" + cfg["curve_id"] + b"_XMD:BLAKE2b_" + cfg["method"] + b"_RO_"
    dst_prime = dst + bytes([len(dst)])
    h = hashlib.blake2b
    b0 = h(b"\x00" * 128 + msg + b"\x00\x80\x00" + dst_prime, digest_size=64).digest()
    b1 = h(b0 + b"\x01" + dst_prime, digest_size=64).digest()
    b2 = h(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime,
           digest_size=64).digest()
    return int.from_bytes(b1, "big") % p, int.from_bytes(b2, "big") % p


def _sswu(p: int, cfg: dict, u: int):
    A, B, Z = cfg["iso_a"], cfg["iso_b"], cfg["z"]
    u2 = u * u % p
    tv1 = (Z * Z % p * (u2 * u2 % p) + Z * u2) % p
    if tv1 == 0:
        x1 = B * pow(Z * A, -1, p) % p
    else:
        x1 = (p - B) * pow(A, -1, p) % p * (1 + pow(tv1, -1, p)) % p
    y = sqrt(x1 * x1 * x1 + A * x1 + B, p)
    if y is None:
        x1 = Z * u2 % p * x1 % p
        y = sqrt(x1 * x1 * x1 + A * x1 + B, p)
    if (u & 1) != (y & 1):
        y = p - y
    return x1, y


def _iso(p: int, cfg: dict, P: Point) -> Point:
    if P is None:
        return None
    x, y = P

    def horner(coeffs):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    xd = horner(cfg["x_den"])
    if xd == 0:
        return None
    X = horner(cfg["x_num"]) * pow(xd, -1, p) % p
    Y = y * horner(cfg["y_num"]) % p * pow(horner(cfg["y_den"]), -1, p) % p
    return X, Y


def _svdw(p: int, b: int, cfg: dict, u: int):
    Z, c1, c2, c3, c4 = cfg["z"], cfg["c1"], cfg["c2"], cfg["c3"], cfg["c4"]

    def g(x):
        return (x * x % p * x + b) % p

    tv1 = u * u % p * c1 % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    t = tv1 * tv2 % p
    tv3 = 0 if t == 0 else pow(t, -1, p)
    tv4 = u * tv1 % p * tv3 % p * c3 % p
    x1, x2 = (c2 - tv4) % p, (c2 + tv4) % p
    x3 = ((tv2 * tv2 % p * tv3 % p) ** 2 % p * c4 + Z) % p
    for x in (x1, x2, x3):
        y = sqrt(g(x), p)
        if y is not None:
            break
    if (u & 1) != (y & 1):
        y = p - y
    return x, y


def hash_to_curve(curve_name: str, msg: bytes) -> Point:
    curve, cfg = CURVES[curve_name], MAPS[curve_name]
    p = curve.p
    u0, u1 = _hash_to_field(p, cfg, msg)
    if cfg["method"] == b"SSWU":
        q = _add_a(p, cfg["iso_a"], _sswu(p, cfg, u0), _sswu(p, cfg, u1))
        out = _iso(p, cfg, q)
    else:
        out = add(curve, _svdw(p, curve.b, cfg, u0), _svdw(p, curve.b, cfg, u1))
    if not curve.on_curve(out):
        raise ArithmeticError(f"hash_to_curve left {curve_name}")
    return out


def _add_a(p: int, a: int, P: Point, Q: Point) -> Point:
    """Affine addition on y^2 = x^3 + a x + b (the isogenous curve)."""
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def to_rows(points: List[Point]) -> np.ndarray:
    rows = np.zeros((len(points), 65), dtype=np.uint8)
    for i, P in enumerate(points):
        if P is None:
            rows[i, 64] = 1
        else:
            rows[i, :64] = np.frombuffer(P[0].to_bytes(32, "little") + P[1].to_bytes(32, "little"),
                                         dtype=np.uint8)
    return rows


def from_rows(rows: np.ndarray) -> List[Point]:
    out = []
    for r in rows:
        if r[64]:
            out.append(None)
        else:
            b = r[:64].tobytes()
            out.append((int.from_bytes(b[:32], "little"), int.from_bytes(b[32:], "little")))
    return out


def _derive_part(args):
    curve_name, blocks = args
    return to_rows([hash_to_curve(curve_name, blk) for blk in blocks])


def derive_rows(curve_name: str, label: bytes, n: int, workers: int = 1) -> np.ndarray:
    """The first n generators of `label` as rows (the blinding generator
    first, as the commitment engine reads them)."""
    stream = hashlib.shake_256(label).digest(32 * n)
    blocks = [stream[32 * i: 32 * i + 32] for i in range(n)]
    if workers <= 1 or n < 64:
        return _derive_part((curve_name, blocks))
    step = -(-n // (4 * workers))
    parts = [(curve_name, blocks[i: i + step]) for i in range(0, n, step)]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        return np.concatenate(list(ex.map(_derive_part, parts)))


def key_rows(curve_name: str, label: bytes, n: int, workers: int = None) -> np.ndarray:
    """n generator rows of `label`, from the cache or derived and cached."""
    prefix = f"{curve_name}_{label.decode()}_"
    if os.path.isdir(CACHE_DIR):
        for fn in sorted(os.listdir(CACHE_DIR)):
            if fn.startswith(prefix) and fn.endswith(".npy"):
                try:
                    m = int(fn[len(prefix):-4])
                except ValueError:
                    continue
                if m >= n:
                    return np.load(os.path.join(CACHE_DIR, fn), mmap_mode="r")[:n]
    rows = derive_rows(curve_name, label, n, workers or os.cpu_count() or 1)
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"{prefix}{n}.npy")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, rows)
    os.replace(tmp, path)
    return rows
