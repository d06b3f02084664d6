"""FVec: device-resident field vectors (port of ``nova_tpu/ops/fvec.py``).

An ``FVec`` holds a vector as an ``(n, 16)`` int32 Montgomery limb tensor
in ``.m`` and quacks like an immutable ``Sequence[int]``: iterating or
indexing materializes (cached) host ints, while hot paths dispatch on
``isinstance(v, FVec)`` and stay on the device. Constructors run on CUDA
unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from nova_tpu_torch import profiling
from nova_tpu_torch._device import resolve
from nova_tpu_torch.fields.spec import NUM_LIMBS, FieldSpec
from nova_tpu_torch.fields.tfield import TField


def _tf(field) -> TField:
    return field if isinstance(field, TField) else TField(field)


def _u64_limbs(std16: np.ndarray) -> np.ndarray:
    """(n, 16) standard-form 16-bit limbs -> (n, 4) uint64 limbs."""
    a = std16.astype(np.uint64)
    return np.ascontiguousarray(
        a[:, 0::4] | (a[:, 1::4] << 16) | (a[:, 2::4] << 32) | (a[:, 3::4] << 48)
    )


class FVec:
    """An immutable field vector resident on a device (Montgomery limbs).

    ``m``: (n, NUM_LIMBS) int32 Montgomery-form tensor."""

    __slots__ = ("tf", "m", "_ints", "_limbs64")

    def __init__(self, tf: TField, m, ints=None):
        self.tf = tf
        self.m = m
        self._ints = ints
        self._limbs64 = None

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_ints(field: Union[FieldSpec, TField], ints: Sequence[int],
                  device=None) -> "FVec":
        tf = _tf(field)
        ints = [int(x) for x in ints]
        raw = torch.from_numpy(tf.pack(ints)).to(resolve(device))
        return FVec(tf, tf.to_mont(raw), ints)

    @staticmethod
    def zeros(field: Union[FieldSpec, TField], n: int, device=None) -> "FVec":
        tf = _tf(field)
        m = torch.zeros((n, NUM_LIMBS), dtype=torch.int32, device=resolve(device))
        return FVec(tf, m, [0] * n)

    @staticmethod
    def coerce(field: Union[FieldSpec, TField], v, device=None) -> "FVec":
        if isinstance(v, FVec):
            return v
        return FVec.from_ints(field, v, device=device)

    @property
    def device(self) -> torch.device:
        return self.m.device

    # -- host materialization ------------------------------------------

    def _std(self) -> np.ndarray:
        return self.tf.from_mont(self.m).cpu().numpy()

    def to_ints(self) -> List[int]:
        if self._ints is None:
            from nova_tpu_torch import native

            if native.available():
                profiling.count("conv.to_host", len(self))
                self._ints = native.limbs_to_ints(self.limbs64())
            else:
                self._ints = self.tf.unpack(self._std())
        return self._ints

    def limbs64(self) -> np.ndarray:
        """(n, 4) uint64 little-endian standard-form limbs, cached. On the
        card the product's kernel leaves the Montgomery form before the copy;
        a CPU FVec is reduced in the native binding when it is built (one
        REDC each), as the JAX package does."""
        if self._limbs64 is None:
            from nova_tpu_torch import native

            if self.m.device.type == "cpu" and native.available():
                mont = _u64_limbs(self.m.cpu().numpy())
                self._limbs64 = native.vec_from_mont_l(self.tf.spec.p, mont)
            else:
                self._limbs64 = _u64_limbs(self._std())
        return self._limbs64

    # -- Sequence protocol ---------------------------------------------

    def __len__(self) -> int:
        return int(self.m.shape[0])

    def __getitem__(self, i):
        return self.to_ints()[i]

    def __iter__(self):
        return iter(self.to_ints())

    def __eq__(self, other):
        if isinstance(other, FVec):
            other = other.to_ints()
        if isinstance(other, (list, tuple)):
            return self.to_ints() == list(other)
        return NotImplemented

    def __repr__(self):
        return f"FVec(n={len(self)}, field={self.tf.spec.name}, device={self.device})"

    # -- device ops (all return FVec, no host sync) ---------------------

    def _const(self, r: int):
        return self.tf.const_mont(int(r) % self.tf.spec.p, self.m)

    def axpy(self, r: int, other: "FVec") -> "FVec":
        """self + r*other."""
        tf = self.tf
        return FVec(tf, tf.add(self.m, tf.mont_mul(self._const(r), other.m)))

    def axpy2(self, r: int, o1: "FVec", r2: int, o2: "FVec") -> "FVec":
        """self + r*o1 + r2*o2."""
        tf = self.tf
        s = tf.add(self.m, tf.mont_mul(self._const(r), o1.m))
        return FVec(tf, tf.add(s, tf.mont_mul(self._const(r2), o2.m)))

    def add(self, other: "FVec") -> "FVec":
        return FVec(self.tf, self.tf.add(self.m, other.m))

    def sub(self, other: "FVec") -> "FVec":
        return FVec(self.tf, self.tf.sub(self.m, other.m))

    def mul(self, other: "FVec") -> "FVec":
        return FVec(self.tf, self.tf.mont_mul(self.m, other.m))

    def scale(self, r: int) -> "FVec":
        return FVec(self.tf, self.tf.mont_mul(self._const(r), self.m))

    def pad_to(self, n: int) -> "FVec":
        cur = len(self)
        if cur == n:
            return self
        assert n > cur
        m = torch.cat(
            [self.m, self.m.new_zeros((n - cur, NUM_LIMBS))]
        )
        ints = None if self._ints is None else self._ints + [0] * (n - cur)
        return FVec(self.tf, m, ints)

    def concat_ints(self, tail: Sequence[int]) -> "FVec":
        """Append a short host-side tail (u, X io values) on device."""
        tf = self.tf
        tail = [int(t) % tf.spec.p for t in tail]
        raw = torch.from_numpy(tf.pack(tail)).to(self.device)
        ints = None if self._ints is None else self._ints + tail
        return FVec(tf, torch.cat([self.m, tf.to_mont(raw)]), ints)


def as_list(v) -> list:
    """Materialize host ints from an FVec/HVec or pass a list through."""
    if isinstance(v, (FVec, HVec)):
        return v.to_ints()
    return list(v)


class HVec:
    """Host-side analog of FVec: a field vector held as (n, 4) uint64
    standard-form limbs with lazily materialized Python ints."""

    __slots__ = ("p", "_l", "_ints")

    def __init__(self, p: int, limbs=None, ints=None):
        assert limbs is not None or ints is not None
        self.p = p
        self._l = limbs
        self._ints = list(ints) if ints is not None else None

    def limbs64(self) -> np.ndarray:
        if self._l is None:
            buf = b"".join((x % self.p).to_bytes(32, "little") for x in self._ints)
            self._l = np.frombuffer(buf, dtype="<u8").reshape(-1, 4).copy()
        return self._l

    def to_ints(self) -> List[int]:
        if self._ints is None:
            self._ints = [
                int.from_bytes(row.astype("<u8").tobytes(), "little")
                for row in self._l
            ]
        return self._ints

    def __len__(self):
        return self._l.shape[0] if self._l is not None else len(self._ints)

    def __iter__(self):
        return iter(self.to_ints())

    def __getitem__(self, i):
        return self.to_ints()[i]

    def __eq__(self, other):
        if isinstance(other, HVec):
            return self.to_ints() == other.to_ints()
        if isinstance(other, (list, tuple)):
            return self.to_ints() == list(other)
        return NotImplemented
