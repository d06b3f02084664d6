"""Keccak family (keccak-f[1600] permutation, Keccak-256, SHAKE-256) and the
Nova Fiat-Shamir transcript (copy of ``nova_tpu/provider/keccak.py``; the
permutation runs in the native binding when it is built).

The transcript protocol is re-implemented from the reference semantics
(src/provider/keccak.rs:11-200):

- state: 64 bytes; initialized as
  ``state = H_lo_hi(PERSONA_TAG || label)`` where
  ``H_lo_hi(x) = keccak256(x || 0x00) || keccak256(x || 0x01)``.
- ``absorb(label, bytes)`` appends ``label || bytes`` to a running buffer.
- ``squeeze(label)``: input = buffer || "NoDS" || round_le8 || state || label,
  output = H_lo_hi(input); state <- output, round += 1, buffer cleared;
  the scalar challenge is ``Scalar::from_uniform(output)`` (64-byte LE mod p).
- ``squeeze_bits(label, num_bits, start_with_one)``: truncate output to
  num_bits (LE bit order), optionally force the top bit.

Keccak-256 uses the original Keccak padding (0x01), NOT SHA3's 0x06; Python's
hashlib lacks it, so the permutation is implemented here and verified against
the reference's own embedded vector (src/provider/keccak.rs:280-288).
"""

from __future__ import annotations

from nova_tpu_torch.errors import NovaError

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

    def copy(self) -> "KeccakSponge":
        s = KeccakSponge(self.rate, self.pad_byte)
        s.lanes = [row[:] for row in self.lanes]
        s.buf = bytearray(self.buf)
        return s

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
        from nova_tpu_torch import native

        if native.available():
            self.lanes = native.keccak_f1600_lanes(self.lanes)
        else:
            self.lanes = keccak_f1600(self.lanes)

    def _squeeze(self, n: int) -> bytes:
        # pad10*1 with domain byte
        block = bytearray(self.buf)
        block.append(self.pad_byte)
        while len(block) < self.rate:
            block.append(0)
        block[-1] |= 0x80
        lanes = [row[:] for row in self.lanes]
        for i in range(self.rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            lanes[x][y] ^= lane
        lanes = keccak_f1600(lanes)
        out = bytearray()
        while len(out) < n:
            for i in range(self.rate // 8):
                x, y = i % 5, i // 5
                out.extend(lanes[x][y].to_bytes(8, "little"))
                if len(out) >= n:
                    break
            if len(out) < n:
                lanes = keccak_f1600(lanes)
        return bytes(out[:n])


class Keccak256:
    """Keccak-256 (original padding 0x01), incremental API like sha3 crate."""

    def __init__(self):
        self._sponge = KeccakSponge(rate_bytes=136, pad_byte=0x01)

    def update(self, data: bytes) -> "Keccak256":
        self._sponge.update(bytes(data))
        return self

    def copy(self) -> "Keccak256":
        k = Keccak256.__new__(Keccak256)
        k._sponge = self._sponge.copy()
        return k

    def finalize(self) -> bytes:
        return self._sponge._squeeze(32)


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).finalize()


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

PERSONA_TAG = b"NoTR"
DOM_SEP_TAG = b"NoDS"
KECCAK256_STATE_SIZE = 64
_PREFIX_LO = bytes([0])
_PREFIX_HI = bytes([1])


def _compute_updated_state(hasher: Keccak256, extra: bytes, evm: bool = False) -> bytes:
    """Dual-keccak squeeze (keccak.rs:68-96); the evm feature swaps the
    lo/hi output halves (keccak.rs:84-95)."""
    h = hasher.copy()
    h.update(extra)
    lo = h.copy().update(_PREFIX_LO).finalize()
    hi = h.update(_PREFIX_HI).finalize()
    return (hi + lo) if evm else (lo + hi)


class Keccak256Transcript:
    """Fiat-Shamir transcript; generic over the engine's scalar field.

    ``scalar_field`` is the FieldSpec of the engine's Scalar field (challenge
    target, `E::Scalar::from_uniform`).
    """

    def __init__(self, label: bytes, scalar_field, evm: bool = False):
        self.scalar_field = scalar_field
        self.evm = evm
        self.round = 0
        hasher = Keccak256()
        self.state = _compute_updated_state(hasher, PERSONA_TAG + label, evm)
        self.transcript = Keccak256()
        self.transcript_buffer = bytearray()

    def absorb_bytes(self, label: bytes, repr_bytes: bytes):
        self.transcript.update(label)
        self.transcript_buffer.extend(label)
        self.transcript.update(repr_bytes)
        self.transcript_buffer.extend(repr_bytes)

    def absorb(self, label: bytes, obj):
        """Absorb an object exposing to_transcript_bytes(), or raw bytes."""
        if isinstance(obj, (bytes, bytearray)):
            self.absorb_bytes(label, bytes(obj))
        else:
            self.absorb_bytes(label, obj.to_transcript_bytes())

    def dom_sep(self, tag: bytes):
        self.transcript.update(DOM_SEP_TAG)
        self.transcript_buffer.extend(DOM_SEP_TAG)
        self.transcript.update(tag)
        self.transcript_buffer.extend(tag)

    def _squeeze_raw(self, label: bytes) -> bytes:
        order = "big" if self.evm else "little"
        inp = DOM_SEP_TAG + self.round.to_bytes(8, order) + self.state + label
        output = _compute_updated_state(self.transcript, inp, self.evm)
        if self.round >= (1 << 64) - 1:
            raise NovaError("transcript round overflow")
        self.round += 1
        self.state = output
        self.transcript = Keccak256()
        self.transcript_buffer = bytearray()
        if self.evm:
            output = output[::-1]
        return output

    def squeeze(self, label: bytes) -> int:
        out = self._squeeze_raw(label)
        return self.scalar_field.from_uniform(out)

    def squeeze_bits(self, label: bytes, num_bits: int, start_with_one: bool) -> int:
        assert num_bits >= 2
        assert num_bits <= self.scalar_field.num_bits - 1
        out = self._squeeze_raw(label)
        v = int.from_bytes(out[:32], "little")
        v &= (1 << num_bits) - 1
        if start_with_one:
            v |= 1 << (num_bits - 1)
        return v
