"""Public-parameter digests (reference: src/digest.rs).

SHA3-256 over a canonical byte serialization, truncated to NUM_HASH_BITS
(250) little-endian bits and mapped into a field element.

The byte layout mirrors bincode's legacy fixed-int little-endian encoding of
the Rust structs (length-prefixed vectors with u64 lengths, field elements
as 32-byte LE reprs) so the construction parallels the reference; exact
byte-equality with Rust additionally depends on serde struct layout, which
is pinned here per type via explicit `digest_bytes` writers.
"""

from __future__ import annotations

import hashlib
from typing import List

from nova_tpu_torch.constants import NUM_HASH_BITS
from nova_tpu_torch.fields.spec import FieldSpec


def map_to_field(digest: bytes, field: FieldSpec) -> int:
    """src/digest.rs:47-64: take NUM_HASH_BITS little-endian bits."""
    v = int.from_bytes(digest, "little")
    return v & ((1 << NUM_HASH_BITS) - 1)


def _u64(v: int) -> bytes:
    return v.to_bytes(8, "little")


class DigestComputer:
    @staticmethod
    def digest_bytes_sparse(M) -> bytes:
        out = bytearray()
        out += _u64(len(M.data))
        for v in M.data:
            out += M.field.to_repr(v)
        out += _u64(len(M.indices))
        for i in M.indices:
            out += _u64(i)
        out += _u64(len(M.indptr))
        for i in M.indptr:
            out += _u64(i)
        out += _u64(M.cols)
        return bytes(out)

    @staticmethod
    def digest_shape(shape) -> int:
        """R1CSShape digest (SimpleDigestible; bincode legacy layout:
        num_cons, num_vars, num_io as u64 then A, B, C)."""
        h = hashlib.sha3_256()
        h.update(_u64(shape.num_cons))
        h.update(_u64(shape.num_vars))
        h.update(_u64(shape.num_io))
        for M in (shape.A, shape.B, shape.C):
            h.update(DigestComputer.digest_bytes_sparse(M))
        return map_to_field(h.digest(), shape.field)

    @staticmethod
    def digest_raw(data: bytes, field: FieldSpec) -> int:
        return map_to_field(hashlib.sha3_256(data).digest(), field)
