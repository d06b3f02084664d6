"""Pedersen commitment engine (port of ``nova_tpu/provider/pedersen.py``,
reference: src/provider/pedersen.rs).

commit(v, r) = sum_i v_i * G_i + r * H over hashed-to-curve generators.
Generators derive from a label via a Shake256 XOF, one 32-byte block per
generator, lifted to the curve with the halo2curves hash_to_curve map; with
``NOVA_LEGACY_MAP=1`` the earlier try-and-increment map is used instead, so
keys cached under it stay loadable. Keys are cached on disk in the port's
own cache directory, in the same ``.npy`` row format and under the same
names as the JAX package (``ck2_`` for the hash-to-curve map, ``ck_`` for
the legacy one).

Under an active device mesh (``nova_tpu_torch.parallel.use_mesh``) a commit
of at least 8 entries takes the sharded MSM (``msm_sharded``) before any
other route, and ``batch_commit``/``commit_small`` skip their batched and
device routes, as in the JAX package; ``commit_limbs`` (the host-native
cross-terms) takes it too, so every commit of a meshed step is sharded.

Routing: an ``FVec`` takes the fixed-base device MSM (``msm_device3_mont``)
on the device it lives on, whatever its length (the JAX package brings one
shorter than FOLD_DEVICE_THRESHOLD to the host; on the card the device MSM
is the faster route at every length measured, PERF.md); an ``HVec`` takes
the native host MSM when the native binding is available; an int list of
at least DEVICE_THRESHOLD entries takes the int-scalar device MSM
(``msm_device2``) on the key's device, one of 16 or more the native host
MSM, a shorter one the host Pippenger; ``commit_small`` sends long lists
to the device MSM with a bit bound. The sparse and sub-range commits and
the derived keys of NeutronNova and Spark take the native host MSM and
segmented batch add where the binding is built, and the reference's host
loops where it is not.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context
from typing import List, Sequence

import numpy as np

from nova_tpu_torch import constants
from nova_tpu_torch.constants import BN_LIMB_WIDTH, BN_N_LIMBS
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


def map_to_curve_legacy(curve: CurveSpec, uniform_bytes: bytes) -> AffinePoint:
    """The try-and-increment map used behind NOVA_LEGACY_MAP=1: read 32
    bytes as a little-endian integer u; take x = (u mod p) + ctr for the
    smallest ctr >= 0 making x^3 + b a square; pick the root whose parity
    equals bit 255 of u."""
    f = curve.base
    u = int.from_bytes(uniform_bytes, "little")
    parity = (u >> 255) & 1
    x = u % f.p
    while True:
        y = f.sqrt(f.add(f.mul(f.mul(x, x), x), curve.b % f.p))
        if y is not None:
            if y & 1 != parity:
                y = f.p - y
            return AffinePoint(curve, x, y)
        x = f.add(x, 1)


def _use_legacy_map() -> bool:
    return os.environ.get("NOVA_LEGACY_MAP") == "1"


def from_label(curve: CurveSpec, label: bytes, n: int,
               workers: int = 1) -> List[AffinePoint]:
    """Derive n generators from a label (DlogGroup::from_label semantics,
    src/provider/traits.rs:249-293): Shake256(label) XOF -> 32-byte blocks
    -> hash_to_curve("from_uniform_bytes"), or map_to_curve_legacy under
    NOVA_LEGACY_MAP=1 (a serial loop: `workers` is not used). With
    `workers` > 1 the blocks are hashed in a process pool; the list is the
    same."""
    reader = Shake256().update(label).finalize_xof()
    blocks = [reader.read(32) for _ in range(n)]
    if _use_legacy_map():
        return [map_to_curve_legacy(curve, blk) for blk in blocks]
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
    _host: object = field(default=None, repr=False, compare=False)
    # serde writes the JAX package's fields only: a key read back from bytes
    # has the default device
    _serde_local = ("device",)

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

    def host_arrays(self, n: int):
        """Limb-marshalled generator arrays for native.msm_cached, cached
        (one Python-int -> limb conversion per key)."""
        from nova_tpu_torch import native

        arrs = self._host
        if arrs is None or arrs[0].shape[0] < n:
            arrs = native.marshal_points(self.ck[: max(n, len(self.ck))])
            self._host = arrs
        return arrs

    # split/combine/fold/scale for IPA (CommitmentKeyExtTrait,
    # src/provider/pedersen.rs:431-529)
    def split_at(self, n: int):
        """(first n generators, the rest). The left piece is a prefix, so it
        shares the marshalled host arrays and device bases."""
        left = CommitmentKey(self.curve, self.ck[:n], self.h, self.device)
        if self._host is not None and self._host[0].shape[0] >= n:
            left._host = self._host
        left._db = self._db
        return left, CommitmentKey(self.curve, self.ck[n:], self.h, self.device)

    def combine(self, other: "CommitmentKey") -> "CommitmentKey":
        return CommitmentKey(self.curve, self.ck + other.ck, self.h, self.device)

    def fold(self, w1: int, w2: int) -> "CommitmentKey":
        """[w1 * L_i + w2 * R_i] over the two halves."""
        from nova_tpu_torch import native

        half = len(self.ck) // 2
        L, R = self.ck[:half], self.ck[half:]
        if native.available() and half > 0:
            ck = native.ec_fold(L, R, w1, w2)
        else:
            ck = [l.mul(w1).add(r.mul(w2)) for l, r in zip(L, R)]
        return CommitmentKey(self.curve, ck, self.h, self.device)

    def scale(self, r: int) -> "CommitmentKey":
        from nova_tpu_torch import native

        if native.available() and len(self.ck) > 1:
            return CommitmentKey(self.curve, native.ec_scale(self.ck, r), self.h,
                                 self.device)
        return CommitmentKey(self.curve, [g.mul(r) for g in self.ck], self.h,
                             self.device)


@dataclass
class DerandKey:
    curve: CurveSpec
    h: AffinePoint


class Commitment:
    """A Pedersen commitment: a group element with the reference's
    transcript/RO absorption conventions."""

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

    def absorb_in_ro(self, ro):
        """Absorb (x, y, infinity) in the base-field RO
        (src/provider/pedersen.rs:120-135)."""
        x, y, inf = self.point.to_coordinates()
        ro.absorb(x)
        ro.absorb(y)
        ro.absorb(1 if inf else 0)

    def absorb_in_ro2(self, ro):
        """Absorb in the scalar-field RO as bignat limbs
        (src/provider/pedersen.rs:137-157)."""
        x, y, inf = self.point.to_coordinates()
        mask = (1 << BN_LIMB_WIDTH) - 1
        for v in (x, y):
            for i in range(BN_N_LIMBS):
                ro.absorb((v >> (BN_LIMB_WIDTH * i)) & mask)
        ro.absorb(1 if inf else 0)


def _load_gen_cache(path, curve, num):
    """Cached generators from the raw .npy rows x[32] | y[32] | inf[1]."""
    with open(path, "rb") as fh:
        rows = np.load(fh, allow_pickle=False)
    return gens_from_rows(curve, rows[:num])


def gens_from_rows(curve, rows) -> List[AffinePoint]:
    """Points from (N, 65) uint8 rows x[32] | y[32] | inf[1], little-endian
    (the key cache's row format)."""
    out = []
    for r in rows:
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
        (all cores by default) and cached. The cache name's tag says the
        map: "ck2" for hash-to-curve, "ck" for the legacy map."""
        num = _next_pow2(n) + 1
        tag = "ck" if _use_legacy_map() else "ck2"
        prefix = f"{tag}_{curve.name}_{label.decode()}_"
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
    def derand_key(ck: CommitmentKey) -> DerandKey:
        return DerandKey(ck.curve, ck.h)

    @staticmethod
    def derandomize(dk: DerandKey, commit: Commitment, r: int) -> Commitment:
        return Commitment(commit.point.sub(dk.h.mul(r)))

    @staticmethod
    def commit(ck: CommitmentKey, v: Sequence[int], r: int = 0) -> Commitment:
        from nova_tpu_torch import native
        from nova_tpu_torch.ops.fvec import FVec, HVec
        from nova_tpu_torch.parallel import current_mesh

        assert len(ck.ck) >= len(v), (len(ck.ck), len(v))
        mesh = current_mesh()
        if mesh is not None and len(v) >= 8:
            from nova_tpu_torch.parallel import msm_sharded

            acc = msm_sharded(v, mesh=mesh, device_bases=ck.device_bases2(len(v)))
            return _with_blind(ck, acc, r)
        if isinstance(v, HVec) and native.available():
            return CommitmentEngine.commit_limbs(ck, v.limbs64(), r)
        if isinstance(v, FVec):
            from nova_tpu_torch.ops.msm3 import msm_device3_mont

            if len(v) == 0:
                return _with_blind(ck, AffinePoint.identity(ck.curve), r)
            acc = msm_device3_mont(v.m, ck.device_bases2(len(v)))
            return _with_blind(ck, acc, r)
        v = list(v)
        if not v:
            acc = AffinePoint.identity(ck.curve)
        elif len(v) >= constants.DEVICE_THRESHOLD:
            from nova_tpu_torch.ops.msm2 import msm_device2

            acc = msm_device2(v, device_bases=ck.device_bases2(len(v)), reuse=True)
        elif native.available() and len(v) >= 16:
            acc = native.msm_cached(ck.curve, ck.host_arrays(len(v)), v)
        else:
            acc = host_msm(v, ck.ck[: len(v)])
        return _with_blind(ck, acc, r)

    @staticmethod
    def commit_limbs(ck: CommitmentKey, vl, r: int = 0) -> Commitment:
        """Commit to a vector given as (n, 4) uint64 normal-form limbs (the
        native kernels' boundary format). Under a mesh, 8 or more rows take
        the sharded MSM, as commit does (the JAX package's commit_limbs has
        no mesh branch; the commitment is the same)."""
        from nova_tpu_torch import native
        from nova_tpu_torch.parallel import current_mesh

        n = vl.shape[0]
        assert len(ck.ck) >= n
        mesh = current_mesh()
        if mesh is not None and n >= 8:
            from nova_tpu_torch.ops.fvec import HVec
            from nova_tpu_torch.parallel import msm_sharded

            acc = msm_sharded(HVec(ck.curve.scalar.p, limbs=vl), mesh=mesh,
                              device_bases=ck.device_bases2(n))
        elif native.available():
            acc = native.msm_cached(ck.curve, ck.host_arrays(n), vl)
        else:
            acc = host_msm(native.limbs_to_ints(vl), ck.ck[:n])
        return _with_blind(ck, acc, r)

    @staticmethod
    def batch_commit(ck: CommitmentKey, vs, rs) -> list:
        """commitment.rs:94-104. Device-resident (FVec) vectors go through
        the batched MSM, unless a mesh is active: all are queued before the
        first result is read."""
        from nova_tpu_torch.ops.fvec import FVec
        from nova_tpu_torch.parallel import current_mesh

        assert len(vs) == len(rs)
        if (len(vs) > 1 and current_mesh() is None
                and all(isinstance(v, FVec) and len(v) for v in vs)):
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
        max bit width. Under a mesh it is a plain commit (the sharded MSM)."""
        from nova_tpu_torch.ops.fvec import FVec
        from nova_tpu_torch.parallel import current_mesh

        if (current_mesh() is None and not isinstance(v, FVec)
                and len(v) >= constants.DEVICE_THRESHOLD):
            from nova_tpu_torch.ops.msm3 import msm_device3

            vl = [int(x) for x in v]
            mb = max((x.bit_length() for x in vl), default=1)
            acc = msm_device3(
                vl, device_bases=ck.device_bases2(len(vl)), max_bits=max(mb, 1)
            )
            return _with_blind(ck, acc, r)
        return CommitmentEngine.commit(ck, v, r)

    @staticmethod
    def batch_commit_small(ck: CommitmentKey, vs, rs) -> list:
        assert len(vs) == len(rs)
        return [CommitmentEngine.commit_small(ck, v, r) for v, r in zip(vs, rs)]

    @staticmethod
    def commit_small_range(
        ck: CommitmentKey, v: Sequence[int], r: int, range_: range, max_num_bits: int
    ) -> Commitment:
        """Commit over a generator sub-range (pedersen.rs:285-315)."""
        from nova_tpu_torch import native

        bases = ck.ck[range_.start : range_.stop]
        assert len(bases) >= len(v)
        if not v:
            acc = AffinePoint.identity(ck.curve)
        elif native.available():
            acc = native.msm_cached(
                ck.curve, ck.host_arrays(range_.start + len(v)), list(v),
                indices=list(range(range_.start, range_.start + len(v))),
            )
        else:
            acc = host_msm(list(v), bases[: len(v)])
        return _with_blind(ck, acc, r)

    @staticmethod
    def ck_derive_by_address(
        ck: CommitmentKey, addresses: Sequence[int], table_size: int
    ) -> CommitmentKey:
        """Derived key: G'_j = sum_{i: addr[i]=j} G_i (pedersen.rs:360-381),
        on the same device as `ck`."""
        from nova_tpu_torch import native
        from nova_tpu_torch.errors import InvalidCommitmentKeyLengthError, InvalidIndexError

        if len(addresses) > len(ck.ck):
            raise InvalidCommitmentKeyLengthError()
        if any(j >= table_size for j in addresses):
            raise InvalidIndexError()
        if native.available() and addresses:
            addr = np.asarray(addresses, dtype=np.uint32)
            order = np.argsort(addr, kind="stable").astype(np.uint32)
            counts = np.bincount(addr, minlength=table_size)
            seg_off = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(counts)]
            ).astype(np.uint32)
            acc = native.batch_add_seg(
                ck.curve, ck.host_arrays(len(addresses)), order, seg_off
            )
        else:
            acc = [AffinePoint.identity(ck.curve) for _ in range(table_size)]
            for i, j in enumerate(addresses):
                acc[j] = acc[j].add(ck.ck[i])
        return CommitmentKey(ck.curve, acc, ck.h, ck.device)

    @staticmethod
    def commit_sparse(
        ck: CommitmentKey, indices: Sequence[int], scalars: Sequence[int], r: int = 0
    ) -> Commitment:
        from nova_tpu_torch import native

        assert len(indices) == len(scalars)
        if not indices:
            acc = AffinePoint.identity(ck.curve)
        elif native.available():
            acc = native.msm_cached(
                ck.curve, ck.host_arrays(max(indices) + 1), list(scalars),
                indices=list(indices),
            )
        else:
            acc = host_msm(list(scalars), [ck.ck[i] for i in indices])
        return _with_blind(ck, acc, r)

    @staticmethod
    def commit_sparse_binary(
        ck: CommitmentKey, non_zero_indices: Sequence[int], r: int = 0
    ) -> Commitment:
        from nova_tpu_torch import native

        if native.available() and non_zero_indices:
            acc = native.batch_add_seg(
                ck.curve,
                ck.host_arrays(max(non_zero_indices) + 1),
                list(non_zero_indices),
                [0, len(non_zero_indices)],
            )[0]
        else:
            acc = AffinePoint.identity(ck.curve)
            for i in non_zero_indices:
                acc = acc.add(ck.ck[i])
        return _with_blind(ck, acc, r)
