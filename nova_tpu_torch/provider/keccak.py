"""Keccak-f[1600] and SHAKE-256 (FIPS 202), pure Python.

Copy of the parts of ``nova_tpu/provider/keccak.py`` that Pedersen
generator derivation needs (``from_label`` reads a SHAKE-256 XOF). The
Keccak-256 Fiat-Shamir transcript is not ported yet.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# keccak-f[1600]
# ---------------------------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f1600(lanes):
    """One keccak-f[1600] permutation on a 5x5 list of 64-bit lanes
    (lanes[x][y] layout per FIPS 202)."""
    a = [row[:] for row in lanes]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    return a


class KeccakSponge:
    """Generic Keccak sponge with byte-granular absorb."""

    def __init__(self, rate_bytes: int, pad_byte: int):
        self.rate = rate_bytes
        self.pad_byte = pad_byte
        self.lanes = [[0] * 5 for _ in range(5)]
        self.buf = bytearray()

    def update(self, data: bytes) -> "KeccakSponge":
        self.buf.extend(data)
        while len(self.buf) >= self.rate:
            self._absorb_block(bytes(self.buf[: self.rate]))
            del self.buf[: self.rate]
        return self

    def _absorb_block(self, block: bytes):
        for i in range(self.rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            self.lanes[x][y] ^= lane
        self.lanes = keccak_f1600(self.lanes)


class Shake256:
    """SHAKE-256 XOF (FIPS 202 padding 0x1f) with a streaming reader,
    used for Pedersen generator derivation (from_label,
    src/provider/traits.rs:249-293)."""

    def __init__(self):
        self._sponge = KeccakSponge(rate_bytes=136, pad_byte=0x1F)

    def update(self, data: bytes) -> "Shake256":
        self._sponge.update(bytes(data))
        return self

    def finalize_xof(self) -> "_XofReader":
        return _XofReader(self._sponge)


class _XofReader:
    def __init__(self, sponge: KeccakSponge):
        # absorb final padded block once; then stream squeeze
        block = bytearray(sponge.buf)
        block.append(sponge.pad_byte)
        while len(block) % sponge.rate != 0:
            block.append(0)
        block[-1] |= 0x80
        lanes = [row[:] for row in sponge.lanes]
        for off in range(0, len(block), sponge.rate):
            for i in range(sponge.rate // 8):
                lane = int.from_bytes(block[off + 8 * i : off + 8 * i + 8], "little")
                x, y = i % 5, i // 5
                lanes[x][y] ^= lane
            lanes = keccak_f1600(lanes)
        self._lanes = lanes
        self._rate = sponge.rate
        self._pending = bytearray()
        self._fill()

    def _fill(self):
        for i in range(self._rate // 8):
            x, y = i % 5, i // 5
            self._pending.extend(self._lanes[x][y].to_bytes(8, "little"))

    def read(self, n: int) -> bytes:
        while len(self._pending) < n:
            self._lanes = keccak_f1600(self._lanes)
            self._fill()
        out = bytes(self._pending[:n])
        del self._pending[:n]
        return out


# ---------------------------------------------------------------------------
# Nova transcript (reference: src/provider/keccak.rs)
# ---------------------------------------------------------------------------
