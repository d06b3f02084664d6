"""Typed structural serialization for proofs, keys, and IVC checkpoints
(port of ``nova_tpu/serde.py``; the bytes are the JAX package's).

Replaces pickle (arbitrary code execution on load — proofs and checkpoints
are adversarial inputs). The reference uses serde/bincode with typed
decoding and point validation (src/nova/mod.rs:319-320, provider/
pedersen.rs:317-393); this is the analogous surface for the Python objects:

- a small closed value universe: None/bool/int/str/bytes/list/tuple/dict
- objects encode as (class path, field dict) and decode via cls.__new__ +
  setattr — no constructor, __reduce__, or __setstate__ ever runs, and the
  class must live in this package
- AffinePoint, CurveSpec, FieldSpec and Engine encode SYMBOLICALLY (curve
  name / field prime) and decode through fixed registries; points are
  on-curve-validated at decode, so a forged proof cannot smuggle invalid
  group elements or bogus curve parameters.

Format: tag byte + big-endian u32/u64 lengths, recursive.

Class paths are written as the JAX package names its counterpart class
(this package's ``nova_tpu_torch.`` prefix written as ``nova_tpu.``) and
mapped back on load, so both packages write the same bytes for the same
proof and read each other's. A path without that prefix is refused before
anything is imported, and a path is never resolved into the JAX package.
Field vectors (``FVec``, ``HVec``) are written as their int lists; a
vector on the card is copied to the host. Fields a class lists in
``_serde_local`` (a commitment key's ``device``) are not written: an
object read back takes the class default (None: CUDA).
"""

from __future__ import annotations

import importlib
import struct
from io import BytesIO

from nova_tpu_torch.errors import NovaError

_MAX_DEPTH = 64

# this package's module prefix, and the one the byte format names it by
_PKG = "nova_tpu_torch."
_WIRE = "nova_tpu."


def _wire_path(module: str, qualname: str) -> str:
    """The written path of a class of this package."""
    return f"{_WIRE}{module[len(_PKG):]}:{qualname}"


def _ours(module: str) -> bool:
    return module.startswith(_PKG)


def _curve_registry():
    from nova_tpu_torch.curves import spec as cs

    return {
        c.name: c
        for c in (cs.pallas, cs.vesta, cs.bn254, cs.grumpkin, cs.secp256k1, cs.secq256k1)
    }


def _field_registry():
    out = {}
    for c in _curve_registry().values():
        out[c.base.p] = c.base
        out[c.scalar.p] = c.scalar
    return out


def _engine_registry():
    from nova_tpu_torch.provider.engines import Engine

    return Engine._registry


def _encode_int(buf: BytesIO, v: int) -> None:
    sign = 1 if v < 0 else 0
    mag = -v if sign else v
    raw = mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big")
    buf.write(b"I")
    buf.write(struct.pack(">BI", sign, len(raw)))
    buf.write(raw)


def dumps(obj) -> bytes:
    buf = BytesIO()
    _enc(buf, obj, 0)
    return buf.getvalue()


# --- EVM-compatible big-endian flavour (reference `evm` feature:
# src/traits/evm_serde.rs + the per-curve CustomSerdeTrait impls, which
# fix field elements to 32-byte big-endian words and points to validated
# uncompressed coordinates so Solidity verifiers can parse proofs) ------

_EVM = False


def dumps_evm(obj) -> bytes:
    """Serialize with fixed 32-byte big-endian integers (EVM word layout)
    and uncompressed point coordinates. Raises for integers >= 2^256."""
    global _EVM
    buf = BytesIO()
    _EVM = True
    try:
        _enc(buf, obj, 0)
    finally:
        _EVM = False
    return buf.getvalue()


def loads_evm(data: bytes):
    return loads(data)


def _enc(buf: BytesIO, v, depth: int) -> None:
    from nova_tpu_torch.curves.spec import AffinePoint, CurveSpec
    from nova_tpu_torch.fields.spec import FieldSpec
    from nova_tpu_torch.provider.engines import Engine

    if depth > _MAX_DEPTH:
        raise NovaError("serialization depth exceeded")
    if v is None:
        buf.write(b"N")
    elif v is True:
        buf.write(b"T")
    elif v is False:
        buf.write(b"F")
    elif isinstance(v, int):
        if _EVM:
            if not 0 <= v < (1 << 256):
                raise NovaError("EVM serialization requires 0 <= int < 2^256")
            buf.write(b"J")
            buf.write(v.to_bytes(32, "big"))
        else:
            _encode_int(buf, v)
    elif isinstance(v, str):
        raw = v.encode()
        buf.write(b"S")
        buf.write(struct.pack(">I", len(raw)))
        buf.write(raw)
    elif isinstance(v, (bytes, bytearray)):
        buf.write(b"B")
        buf.write(struct.pack(">I", len(v)))
        buf.write(bytes(v))
    elif type(v).__name__ in ("HVec", "FVec") and type(v).__module__ == _PKG + "ops.fvec":
        # field vectors serialize as their int lists (format-stable across
        # host/device prover paths)
        _enc(buf, v.to_ints(), depth)
    elif isinstance(v, list):
        buf.write(b"L")
        buf.write(struct.pack(">I", len(v)))
        for x in v:
            _enc(buf, x, depth + 1)
    elif isinstance(v, tuple):
        buf.write(b"U")
        buf.write(struct.pack(">I", len(v)))
        for x in v:
            _enc(buf, x, depth + 1)
    elif isinstance(v, dict):
        buf.write(b"D")
        buf.write(struct.pack(">I", len(v)))
        for k, x in v.items():
            if not isinstance(k, str):
                raise NovaError(f"non-str dict key not serializable: {k!r}")
            _enc(buf, k, depth + 1)
            _enc(buf, x, depth + 1)
    elif isinstance(v, AffinePoint) and _EVM:
        # uncompressed big-endian coordinates; identity = all-zero words
        buf.write(b"Q")
        _enc(buf, v.curve.name, depth + 1)
        if v.infinity:
            buf.write(b"\x00" * 64)
        else:
            buf.write(v.x.to_bytes(32, "big"))
            buf.write(v.y.to_bytes(32, "big"))
    elif isinstance(v, AffinePoint):
        buf.write(b"P")
        _enc(buf, v.curve.name, depth + 1)
        _enc(buf, v.x, depth + 1)
        _enc(buf, v.y, depth + 1)
        _enc(buf, bool(v.infinity), depth + 1)
    elif isinstance(v, CurveSpec):
        buf.write(b"C")
        _enc(buf, v.name, depth + 1)
    elif isinstance(v, FieldSpec):
        buf.write(b"G")
        _enc(buf, v.p, depth + 1)
    elif isinstance(v, Engine):
        buf.write(b"E")
        _enc(buf, v.name, depth + 1)
    elif isinstance(v, type):
        # class references (e.g. an EE class on a verifier key)
        if not _ours(v.__module__):
            raise NovaError(f"class outside nova_tpu_torch not serializable: {v}")
        if "." in v.__qualname__:
            # _resolve_class refuses dotted quals; fail at encode time too
            raise NovaError(f"nested class not serializable: {v}")
        buf.write(b"K")
        _enc(buf, _wire_path(v.__module__, v.__qualname__), depth + 1)
    elif _ours(v.__class__.__module__) and (
        hasattr(v, "__dict__") or hasattr(v.__class__, "__slots__")
    ):
        cls = v.__class__
        buf.write(b"O")
        _enc(buf, _wire_path(cls.__module__, cls.__qualname__), depth + 1)
        if hasattr(v, "__dict__"):
            items = v.__dict__.items()
        else:
            items = (
                (k, getattr(v, k)) for k in cls.__slots__ if hasattr(v, k)
            )
        # a class names the fields that only place it on this process's
        # devices (the JAX counterpart has none): not part of the bytes
        local = getattr(cls, "_serde_local", ())
        fields = {k: x for k, x in items if not k.startswith("_") and k not in local}
        _enc(buf, fields, depth + 1)
    else:
        raise NovaError(f"not serializable: {type(v)}")


def loads(data: bytes):
    buf = BytesIO(data)
    v = _dec(buf, 0)
    if buf.read(1):
        raise NovaError("trailing bytes in serialized data")
    return v


def _read(buf: BytesIO, n: int) -> bytes:
    raw = buf.read(n)
    if len(raw) != n:
        raise NovaError("truncated serialized data")
    return raw


def _resolve_class(path: str) -> type:
    """This package's class for a written path: ``nova_tpu.<module>:<name>``
    names ``nova_tpu_torch.<module>``'s class. Every other path is refused
    before any import."""
    if not isinstance(path, str):
        raise NovaError("bad class path in serialized data")
    wire, _, qual = path.partition(":")
    rest = wire[len(_WIRE):]
    if (
        not wire.startswith(_WIRE)
        or not rest
        or not all(part.isidentifier() for part in rest.split("."))
        or not qual.isidentifier()
    ):
        raise NovaError(f"refusing to resolve class {path!r}")
    mod = _PKG + rest
    try:
        module = importlib.import_module(mod)
    except ImportError:
        raise NovaError(f"unknown class {path!r}") from None
    cls = getattr(module, qual, None)
    if not isinstance(cls, type) or cls.__module__ != mod:
        raise NovaError(f"unknown class {path!r}")
    return cls


def _dec(buf: BytesIO, depth: int):
    from nova_tpu_torch.curves.spec import AffinePoint

    if depth > _MAX_DEPTH:
        raise NovaError("serialization depth exceeded")
    tag = _read(buf, 1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        sign, n = struct.unpack(">BI", _read(buf, 5))
        mag = int.from_bytes(_read(buf, n), "big")
        return -mag if sign else mag
    if tag == b"J":
        return int.from_bytes(_read(buf, 32), "big")
    if tag == b"S":
        (n,) = struct.unpack(">I", _read(buf, 4))
        return _read(buf, n).decode()
    if tag == b"B":
        (n,) = struct.unpack(">I", _read(buf, 4))
        return _read(buf, n)
    if tag in (b"L", b"U"):
        (n,) = struct.unpack(">I", _read(buf, 4))
        items = [_dec(buf, depth + 1) for _ in range(n)]
        return items if tag == b"L" else tuple(items)
    if tag == b"D":
        (n,) = struct.unpack(">I", _read(buf, 4))
        out = {}
        for _ in range(n):
            k = _dec(buf, depth + 1)
            if not isinstance(k, str):
                raise NovaError("non-str dict key in serialized data")
            out[k] = _dec(buf, depth + 1)
        return out
    if tag == b"Q":
        name = _dec(buf, depth + 1)
        raw = _read(buf, 64)
        curve = _curve_registry().get(name)
        if curve is None:
            raise NovaError(f"unknown curve {name!r}")
        if raw == b"\x00" * 64:
            return AffinePoint.identity(curve)
        x = int.from_bytes(raw[:32], "big")
        y = int.from_bytes(raw[32:], "big")
        if x >= curve.base.p or y >= curve.base.p:
            raise NovaError("non-canonical coordinate in EVM point")
        pt = AffinePoint(curve, x, y)
        if not pt.is_on_curve():
            raise NovaError("invalid point in serialized data")
        return pt
    if tag == b"P":
        name = _dec(buf, depth + 1)
        x = _dec(buf, depth + 1)
        y = _dec(buf, depth + 1)
        inf = _dec(buf, depth + 1)
        curve = _curve_registry().get(name)
        if curve is None:
            raise NovaError(f"unknown curve {name!r}")
        if inf:
            return AffinePoint.identity(curve)
        pt = AffinePoint(curve, x % curve.base.p, y % curve.base.p)
        if pt.x != x or pt.y != y or not pt.is_on_curve():
            raise NovaError("invalid point in serialized data")
        return pt
    if tag == b"C":
        name = _dec(buf, depth + 1)
        curve = _curve_registry().get(name)
        if curve is None:
            raise NovaError(f"unknown curve {name!r}")
        return curve
    if tag == b"G":
        p = _dec(buf, depth + 1)
        field = _field_registry().get(p)
        if field is None:
            raise NovaError("unknown field modulus")
        return field
    if tag == b"E":
        name = _dec(buf, depth + 1)
        eng = _engine_registry().get(name)
        if eng is None:
            raise NovaError(f"unknown engine {name!r}")
        return eng
    if tag == b"K":
        return _resolve_class(_dec(buf, depth + 1))
    if tag == b"O":
        cls = _resolve_class(_dec(buf, depth + 1))
        fields = _dec(buf, depth + 1)
        if not isinstance(fields, dict):
            raise NovaError("bad object encoding")
        obj = cls.__new__(cls)
        for k, v in fields.items():
            if k.startswith("_") or not k.isidentifier():
                raise NovaError(f"bad field name {k!r}")
            object.__setattr__(obj, k, v)
        return obj
    raise NovaError(f"bad tag {tag!r} in serialized data")
