"""Pedersen commitment engine (port of ``nova_tpu/provider/pedersen.py``,
reference: src/provider/pedersen.rs).

commit(v, r) = sum_i v_i * G_i + r * H over hashed-to-curve generators.
Generators derive from a label via a Shake256 XOF, one 32-byte block per
generator, lifted to the curve with the halo2curves hash_to_curve map.
Keys are cached on disk in the port's own cache directory, in the same
``.npy`` row format as the JAX package.

Routing: an ``FVec`` always takes the device MSM (``msm_device3_mont``) on
the device it lives on; a plain int list is committed by the host
Pippenger (``commit``), or by the device MSM with a bit bound when it is
long enough (``commit_small``).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context
from typing import List, Sequence

import numpy as np

from nova_tpu_torch import constants
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.curves.spec import ALL_CURVES, AffinePoint, CurveSpec
from nova_tpu_torch.provider.keccak import Shake256

_KEY_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_cache")


def _h2c_blocks(args):
    """Worker: hash a list of 32-byte blocks to the named curve; returns
    (x, y, infinity) triples (plain tuples pickle cheaply)."""
    from nova_tpu_torch.provider.hash_to_curve import hash_to_curve

    name, blocks = args
    curve = ALL_CURVES[name]
    out = []
    for blk in blocks:
        p = hash_to_curve(curve, b"from_uniform_bytes", blk)
        out.append((p.x, p.y, p.infinity))
    return out


def from_label(curve: CurveSpec, label: bytes, n: int,
               workers: int = 1) -> List[AffinePoint]:
    """Derive n generators from a label (DlogGroup::from_label semantics,
    src/provider/traits.rs:249-293): Shake256(label) XOF -> 32-byte blocks
    -> hash_to_curve("from_uniform_bytes"). With `workers` > 1 the blocks
    are hashed in a process pool; the list is the same."""
    reader = Shake256().update(label).finalize_xof()
    blocks = [reader.read(32) for _ in range(n)]
    if workers <= 1 or n < 2 * workers:
        triples = _h2c_blocks((curve.name, blocks))
    else:
        step = -(-n // (4 * workers))
        parts = [(curve.name, blocks[i : i + step]) for i in range(0, n, step)]
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
            triples = [t for part in ex.map(_h2c_blocks, parts) for t in part]
    return [AffinePoint(curve, x, y, inf) for x, y, inf in triples]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class CommitmentKey:
    curve: CurveSpec
    ck: list  # List[AffinePoint] generators
    h: AffinePoint  # blinding generator
    device: object = None  # where device_bases2 marshals (CUDA if None)
    _db: object = field(default=None, repr=False, compare=False)

    def __len__(self):
        return len(self.ck)

    def device_bases2(self, n: int):
        """Marshalled bases for the fixed-base MSM (ops/msm3), cached with
        their window-shifted precompute."""
        from nova_tpu_torch.ops.msm2 import DeviceBases2

        db = self._db
        if db is None or db.n < n:
            n_pad = _next_pow2(n)
            db = DeviceBases2(
                self.curve, self.ck[: min(n_pad, len(self.ck))], device=self.device
            )
            self._db = db
        return db


class Commitment:
    """A Pedersen commitment: a group element."""

    __slots__ = ("point",)

    def __init__(self, point: AffinePoint):
        self.point = point

    @staticmethod
    def default(curve: CurveSpec) -> "Commitment":
        return Commitment(AffinePoint.identity(curve))

    def __add__(self, other: "Commitment") -> "Commitment":
        return Commitment(self.point.add(other.point))

    def __sub__(self, other: "Commitment") -> "Commitment":
        return Commitment(self.point.sub(other.point))

    def __mul__(self, scalar: int) -> "Commitment":
        return Commitment(self.point.mul(scalar))

    def __eq__(self, other):
        return self.point == other.point

    def __repr__(self):
        return f"Commitment({self.point!r})"

    def to_coordinates(self):
        return self.point.to_coordinates()

    def to_transcript_bytes(self) -> bytes:
        return self.point.to_transcript_bytes()


def _load_gen_cache(path, curve, num):
    """Cached generators from the raw .npy rows x[32] | y[32] | inf[1]."""
    with open(path, "rb") as fh:
        rows = np.load(fh, allow_pickle=False)
    out = []
    for r in rows[:num]:
        if r[64]:
            out.append(AffinePoint.identity(curve))
        else:
            x = int.from_bytes(r[:32].tobytes(), "little")
            y = int.from_bytes(r[32:64].tobytes(), "little")
            out.append(AffinePoint(curve, x, y))
    return out


def _save_gen_cache(path, gens):
    rows = np.zeros((len(gens), 65), dtype=np.uint8)
    for i, g in enumerate(gens):
        rows[i, :32] = np.frombuffer(g.x.to_bytes(32, "little"), dtype=np.uint8)
        rows[i, 32:64] = np.frombuffer(g.y.to_bytes(32, "little"), dtype=np.uint8)
        rows[i, 64] = 1 if g.infinity else 0
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, rows, allow_pickle=False)
    os.replace(tmp, path)


def _with_blind(ck: CommitmentKey, acc: AffinePoint, r: int) -> Commitment:
    return Commitment(acc.add(ck.h.mul(r)) if r else acc)


class CommitmentEngine:
    """Pedersen commitment engine (CommitmentEngineTrait impl)."""

    @staticmethod
    def setup(curve: CurveSpec, label: bytes, n: int, device=None,
              workers: int = None) -> CommitmentKey:
        """Key of n generators (next power of two, plus the blinding one),
        loaded from the port's cache or derived with `workers` processes
        (all cores by default) and cached."""
        num = _next_pow2(n) + 1
        prefix = f"ck2_{curve.name}_{label.decode()}_"
        cache = os.path.join(_KEY_CACHE_DIR, f"{prefix}{num}.npy")
        gens = None
        if os.path.exists(cache):
            gens = _load_gen_cache(cache, curve, num)
        elif os.path.isdir(_KEY_CACHE_DIR):
            # reuse a larger cached key if present
            for fn in sorted(os.listdir(_KEY_CACHE_DIR)):
                if fn.startswith(prefix) and fn.endswith(".npy"):
                    try:
                        m = int(fn[len(prefix) : -4])
                    except ValueError:
                        continue
                    if m >= num:
                        gens = _load_gen_cache(
                            os.path.join(_KEY_CACHE_DIR, fn), curve, num
                        )
                        break
        if gens is None:
            if workers is None:
                workers = os.cpu_count() or 1
            gens = from_label(curve, label, num, workers=workers)
            os.makedirs(_KEY_CACHE_DIR, exist_ok=True)
            _save_gen_cache(cache, gens)
        return CommitmentKey(curve, gens[1:], gens[0], device=device)

    @staticmethod
    def commit(ck: CommitmentKey, v: Sequence[int], r: int = 0) -> Commitment:
        from nova_tpu_torch.ops.fvec import FVec

        assert len(ck.ck) >= len(v), (len(ck.ck), len(v))
        if isinstance(v, FVec):
            from nova_tpu_torch.ops.msm3 import msm_device3_mont

            if len(v) == 0:
                return _with_blind(ck, AffinePoint.identity(ck.curve), r)
            acc = msm_device3_mont(v.m, ck.device_bases2(len(v)))
            return _with_blind(ck, acc, r)
        v = list(v)
        if not v:
            return _with_blind(ck, AffinePoint.identity(ck.curve), r)
        return _with_blind(ck, host_msm(v, ck.ck[: len(v)]), r)

    @staticmethod
    def batch_commit(ck: CommitmentKey, vs, rs) -> list:
        """commitment.rs:94-104. Device-resident (FVec) vectors go through
        the batched MSM: all are queued before the first result is read."""
        from nova_tpu_torch.ops.fvec import FVec

        assert len(vs) == len(rs)
        if len(vs) > 1 and all(isinstance(v, FVec) and len(v) for v in vs):
            from nova_tpu_torch.ops.msm3 import msm_device3_mont_batch

            accs = msm_device3_mont_batch(
                [v.m for v in vs], ck.device_bases2(max(len(v) for v in vs))
            )
            return [_with_blind(ck, a, r) for a, r in zip(accs, rs)]
        return [CommitmentEngine.commit(ck, v, r) for v, r in zip(vs, rs)]

    @staticmethod
    def commit_small(ck: CommitmentKey, v: Sequence[int], r: int = 0) -> Commitment:
        """Small-scalar commit (commitment.rs:123-136, msm_small routing):
        the device path decomposes only enough windows to cover the actual
        max bit width."""
        from nova_tpu_torch.ops.fvec import FVec

        if not isinstance(v, FVec) and len(v) >= constants.DEVICE_THRESHOLD:
            from nova_tpu_torch.ops.msm3 import msm_device3

            vl = [int(x) for x in v]
            mb = max((x.bit_length() for x in vl), default=1)
            acc = msm_device3(
                vl, device_bases=ck.device_bases2(len(vl)), max_bits=max(mb, 1)
            )
            return _with_blind(ck, acc, r)
        return CommitmentEngine.commit(ck, v, r)
