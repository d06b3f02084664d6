"""Powers-of-Tau (ptau) SRS file I/O (copy of ``nova_tpu/provider/ptau.py``;
reference: src/provider/ptau.rs).

Binary layout (little-endian; identical to the reference / snarkjs-style
pruned PPOT files):
  magic "ptau" | version u32 (=1) | num_sections u32 (11 full, 3 pruned)
  sections: id u32, size i64, payload
    section 1: n8 u32 (=32), modulus (n8 bytes LE), power u32
    section 2: TauG1 — N x G1 points, 64 bytes each (x,y 32-byte LE limbs
               in MONTGOMERY form, matching halo2curves write_raw)
    section 3: TauG2 — M x G2 points, 128 bytes each (x.c0,x.c1,y.c0,y.c1)

read_ptau is the validation boundary: every loaded point must be on-curve;
G2 points must additionally be in the prime-order subgroup (BN254 G2 has a
non-trivial cofactor).
"""

from __future__ import annotations

import io
import os
import re
import struct
from typing import List, Optional, Tuple

from nova_tpu_torch.curves.pairing import (
    CURVE_ORDER,
    G2Point,
    F2_ZERO,
)
from nova_tpu_torch.curves.spec import AffinePoint, bn254
from nova_tpu_torch.errors import PtauFileError

PTAU_VERSION = 1
NUM_SECTIONS_FULL = 11
NUM_SECTIONS_PRUNED = 3
MAX_PPOT_POWER = 28

_P = bn254.base.p
_R = (1 << 256) % _P  # Montgomery radix used by halo2curves bn256
_R_INV = pow(_R, -1, _P)


def _to_mont_bytes(x: int) -> bytes:
    return (x * _R % _P).to_bytes(32, "little")


def _from_mont_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= _P:
        raise PtauFileError("non-canonical field element")
    return v * _R_INV % _P


def _write_g1(pt: AffinePoint) -> bytes:
    if pt.infinity:
        return b"\x00" * 64
    return _to_mont_bytes(pt.x) + _to_mont_bytes(pt.y)


def _read_g1(b: bytes) -> AffinePoint:
    x = _from_mont_bytes(b[:32])
    y = _from_mont_bytes(b[32:64])
    if x == 0 and y == 0:
        return AffinePoint.identity(bn254)
    pt = AffinePoint(bn254, x, y)
    if not pt.is_on_curve():
        raise PtauFileError("G1 point not on curve")
    return pt


def _write_g2(pt: G2Point) -> bytes:
    if pt.inf:
        return b"\x00" * 128
    return (
        _to_mont_bytes(pt.x[0]) + _to_mont_bytes(pt.x[1])
        + _to_mont_bytes(pt.y[0]) + _to_mont_bytes(pt.y[1])
    )


def _read_g2(b: bytes) -> G2Point:
    x = (_from_mont_bytes(b[:32]), _from_mont_bytes(b[32:64]))
    y = (_from_mont_bytes(b[64:96]), _from_mont_bytes(b[96:128]))
    if x == F2_ZERO and y == F2_ZERO:
        return G2Point.identity()
    pt = G2Point(x, y)
    if not pt.is_on_curve():
        raise PtauFileError("G2 point not on curve")
    # subgroup check: r * P == identity
    if not pt.mul(CURVE_ORDER).inf:
        raise PtauFileError("G2 point not in prime-order subgroup")
    return pt


def write_ptau(writer, g1_points: List[AffinePoint], g2_points: List[G2Point], power: int):
    """src/provider/ptau.rs:217-270 (writes the full 11-section layout with
    empty sections 4..11, like the reference)."""
    w = writer
    w.write(b"ptau")
    w.write(struct.pack("<I", PTAU_VERSION))
    w.write(struct.pack("<I", NUM_SECTIONS_FULL))

    # section 1: header
    w.write(struct.pack("<I", 1))
    w.write(struct.pack("<q", 4 + 32 + 4))
    w.write(struct.pack("<I", 32))
    w.write(_P.to_bytes(32, "little"))
    w.write(struct.pack("<I", power))

    # empty trailing sections (ids 0? reference writes id 0 then 4..11)
    w.write(struct.pack("<I", 0))
    w.write(struct.pack("<q", 0))
    for sid in range(4, NUM_SECTIONS_FULL):
        w.write(struct.pack("<I", sid))
        w.write(struct.pack("<q", 0))

    # section 2: TauG1
    w.write(struct.pack("<I", 2))
    payload = b"".join(_write_g1(p) for p in g1_points)
    w.write(struct.pack("<q", len(payload)))
    w.write(payload)

    # section 3: TauG2
    w.write(struct.pack("<I", 3))
    payload = b"".join(_write_g2(p) for p in g2_points)
    w.write(struct.pack("<q", len(payload)))
    w.write(payload)


def _read_metadata(r) -> Tuple[int, int, int]:
    if r.read(4) != b"ptau":
        raise PtauFileError("Invalid magic string")
    (version,) = struct.unpack("<I", r.read(4))
    if version != PTAU_VERSION:
        raise PtauFileError(f"Unsupported version {version}")
    (num_sections,) = struct.unpack("<I", r.read(4))
    if num_sections not in (NUM_SECTIONS_FULL, NUM_SECTIONS_PRUNED):
        raise PtauFileError(f"Invalid number of sections {num_sections}")
    pos = {1: 0, 2: 0, 3: 0}
    for _ in range(num_sections):
        head = r.read(12)
        if len(head) < 12:
            break
        sid, size = struct.unpack("<Iq", head)
        here = r.tell()
        if sid in pos and pos[sid] == 0:
            pos[sid] = here
        r.seek(here + size)
    if not (pos[1] and pos[2] and pos[3]):
        raise PtauFileError("missing sections")
    return pos[1], pos[2], pos[3]


def _read_header(r, num_g1: int, num_g2: int):
    (n8,) = struct.unpack("<I", r.read(4))
    modulus = int.from_bytes(r.read(n8), "little")
    if modulus != _P:
        raise PtauFileError("Invalid base prime")
    (power,) = struct.unpack("<I", r.read(4))
    max_g2 = 1 << power
    max_g1 = 2 * max_g2 - 1
    if num_g1 > max_g1:
        raise PtauFileError(f"Insufficient power {power} for {num_g1} G1 points")
    if num_g2 > max_g2:
        raise PtauFileError(f"Insufficient power {power} for {num_g2} G2 points")


def read_ptau(reader, num_g1: int, num_g2: int) -> Tuple[List[AffinePoint], List[G2Point]]:
    pos_header, pos_g1, pos_g2 = _read_metadata(reader)
    reader.seek(pos_header)
    _read_header(reader, num_g1, num_g2)
    reader.seek(pos_g1)
    g1 = [_read_g1(reader.read(64)) for _ in range(num_g1)]
    reader.seek(pos_g2)
    g2 = [_read_g2(reader.read(128)) for _ in range(num_g2)]
    return g1, g2


def check_sanity_of_ptau_file(path, num_g1: int, num_g2: int) -> None:
    with open(path, "rb") as f:
        pos_header, _, _ = _read_metadata(f)
        f.seek(pos_header)
        _read_header(f, num_g1, num_g2)


def prune_ptau(src_path, dst_path, power: int) -> None:
    """Copy only header + 2^power+1 G1 + 2 G2 points (the ppot_prune tool,
    examples/ppot_prune.rs): ~18x smaller files."""
    with open(src_path, "rb") as f:
        g1, g2 = read_ptau(f, (1 << power) + 1, 2)
    with open(dst_path, "wb") as f:
        write_ptau(f, g1, g2, power)


def write_test_ptau(path, tau: int, power: int) -> None:
    """Generate an INSECURE test SRS (ptau_test_setup example)."""
    from nova_tpu_torch import native

    g = AffinePoint.generator(bn254)
    n = (1 << power) + 1
    r = CURVE_ORDER
    scalars = []
    cur = 1
    for _ in range(n):
        scalars.append(cur)
        cur = cur * tau % r
    if native.available():
        # one shared fixed-base window table (32 mixed adds a scalar): the
        # points of ec_mul_many for the 2^power + 1 multiples of one base
        g1 = native.ec_fixed_mul_many(g, scalars)
    else:
        g1 = [g.mul(s) for s in scalars]
    g2gen = G2Point.generator()
    g2 = [g2gen, g2gen.mul(tau)]
    with open(path, "wb") as f:
        write_ptau(f, g1, g2, power)


def load_ck_from_ptau(path, n: int, device=None):
    """Build a HyperKZG commitment key (powers-of-tau G1 + tau_H) from a
    ptau file (R1CSShape::commitment_key ptau path, src/r1cs/mod.rs:294-343);
    its device MSMs run on `device` (CUDA unless given)."""
    from nova_tpu_torch.provider.pedersen import CommitmentKey

    n_pow2 = 1 if n <= 1 else 1 << (n - 1).bit_length()
    with open(path, "rb") as f:
        g1, g2 = read_ptau(f, n_pow2, 2)
    # blinding generator via from_label, independent of the tau powers
    # (reference hyperkzg.rs:660-675 load_setup); reading exactly n_pow2 G1
    # points keeps 2^k-sized pruned files loadable for 2^k keys
    from nova_tpu_torch.provider.pedersen import from_label

    ck = CommitmentKey(bn254, g1[:n_pow2], from_label(bn254, b"h", 1)[0], device=device)
    ck._tau_H = g2[1]
    return ck


_PTAU_NAME = re.compile(r"ppot_(?:pruned|0080)_(\d+)\.ptau$")


def find_ptau_file(dir_path, n: int) -> Optional[str]:
    """Smallest file in dir with 2^power >= n (src/r1cs/mod.rs:294-343)."""
    need_power = max(1, (n - 1).bit_length())
    best = None
    for name in os.listdir(dir_path):
        m = _PTAU_NAME.search(name)
        if not m:
            if name == "ppot_0080_final.ptau":
                power = MAX_PPOT_POWER
            else:
                continue
        else:
            power = int(m.group(1))
        if power >= need_power and (best is None or power < best[0]):
            best = (power, os.path.join(dir_path, name))
    return best[1] if best else None
