"""ctypes binding for the C++ host kernels (copy of ``nova_tpu/native``).

The source is the repository's shared ``native/nova_native.cpp``, which this
module only reads. At first use it is compiled with ``g++`` (the JAX
package's flags) into ``nova_tpu_torch/_build/native-<hash of source and
flags>/``, a directory git ignores, so a changed source rebuilds and the JAX
package's own ``.so`` is never touched. ``available()`` is False when the
source, the compiler or the build is missing; callers then keep their
pure-Python branches (``chip_smoke.py`` requires it to be True).

All boundary values are numpy (n, 4) uint64 little-endian limb arrays in
normal (non-Montgomery) form. Every entry point of the JAX package's
binding is bound here, with the same signatures and marshalling.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nova_tpu_torch.curves.spec import AffinePoint

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "nova_native.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-fno-exceptions", "-fomit-frame-pointer")
LIB_NAME = "libnova_native.so"

_lib = None
_lib_lock = threading.Lock()
_ctx_cache: dict = {}

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_SIZE = ctypes.c_size_t
# entry point -> arguments after the field context
_SIGNATURES = {
    "vec_mulmod": [_u64p, _u64p, _u64p, _SIZE],
    "vec_addmod": [_u64p, _u64p, _u64p, _SIZE],
    "vec_invmod": [_u64p, _u64p, _SIZE],
    "vec_cross": [_u64p, _u64p, _u64p, _u64p, _u64p, _u64p, _SIZE],
    "vec_cross_relaxed": [_u64p] * 11 + [_SIZE],
    "vec_from_mont": [_u64p, _u64p, _SIZE],
    "inv_mod": [_u64p, _u64p],
    "neutron_round": [_u64p] * 8 + [_SIZE, _SIZE, _u64p],
    "sumcheck_cubicprod_round": [_u64p, _u64p, _u64p, _SIZE, _u64p],
    "sumcheck_quadeval_round": [_u64p, _u64p, _SIZE, _u64p],
    "sumcheck_linear_round": [_u64p, _u64p, _SIZE, _u64p],
    "poly_eval_horner": [_u64p, _SIZE, _u64p, _u64p],
    "poly_div_linear": [_u64p, _SIZE, _u64p, _u64p],
    "ntt": [_u64p, _SIZE, _u64p, ctypes.c_int],
    "batch_add_seg": [_u64p, _u64p, _u8p, _u32p, _u32p, _SIZE, _u64p, _u64p, _u8p],
    "ec_fixed_mul_many": [_u64p, _u64p, _u64p, _SIZE, _u64p, _u64p, _u8p],
    "ec_mul_many": [_u64p, _u64p, _u8p, _u64p, _SIZE, _u64p, _u64p, _u8p],
    "vec_axpy": [_u64p, _u64p, _u64p, _u64p, _SIZE],
    "vec_fold": [_u64p, _u64p, _u64p, _u64p, _u64p, _SIZE],
    "vec_dot": [_u64p, _u64p, _u64p, _SIZE],
    "vec_batch_inv": [_u64p, _u64p, _SIZE],
    "spmv": [_u64p, _u8p, _u32p, _u32p, _SIZE, _u64p, _u64p],
    "eq_evals": [_u64p, _SIZE, _u64p],
    "sumcheck_cubic_round": [_u64p, _u64p, _u64p, _u64p, _SIZE, _u64p],
    "sumcheck_quad_round": [_u64p, _u64p, _SIZE, _u64p],
    "sumcheck_cubic_gruen_round": [_u64p, _u64p, _u64p, _u64p, _SIZE, _u64p],
    "msm": [_u64p, _u64p, _u8p, _u64p, _SIZE, _u64p, _u64p, _u8p],
    "msm_idx": [_u64p, _u64p, _u8p, _u64p, _u32p, _SIZE, _u64p, _u64p, _u8p],
    "ec_fold": [_u64p, _u64p, _u8p, _u64p, _u64p, _u8p, _u64p, _u64p,
                _SIZE, _u64p, _u64p, _u8p],
    "ec_scale": [_u64p, _u64p, _u8p, _u64p, _SIZE, _u64p, _u64p, _u8p],
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


def _build() -> Optional[str]:
    """Path of the shared library, compiling it first if this source digest
    has not been built yet; None if the source or the build is missing."""
    if not os.path.exists(SRC):
        return None
    out_dir = os.path.join(BUILD_ROOT, f"native-{_digest()}")
    so = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-native-", dir=BUILD_ROOT)
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", os.path.join(tmp, LIB_NAME)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        shutil.rmtree(tmp, ignore_errors=True)
        return None
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def _load() -> Optional[ctypes.CDLL]:
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.ctx_new.restype = ctypes.c_void_p
    lib.ctx_new.argtypes = [_u64p]
    for name, extra in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p] + extra
    lib.vec_sat_check.restype = _SIZE
    lib.vec_sat_check.argtypes = [ctypes.c_void_p] + [_u64p] * 5 + [_SIZE]
    lib.keccak_f1600.restype = None
    lib.keccak_f1600.argtypes = [_u64p]
    lib.poseidon_ctx_new.restype = ctypes.c_void_p
    lib.poseidon_ctx_new.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _u64p, _SIZE, _u64p, _u64p,
                                     _u64p, _u64p]
    lib.poseidon_permute.restype = None
    lib.poseidon_permute.argtypes = [ctypes.c_void_p, _u64p]
    lib.poseidon_permute_witness.restype = _SIZE
    lib.poseidon_permute_witness.argtypes = [ctypes.c_void_p, _u64p, _u64p, ctypes.c_int]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load() or False
    return _lib or None


def available() -> bool:
    return _get_lib() is not None


def _ctx(p: int):
    lib = _get_lib()
    if lib is None:
        return None
    if p not in _ctx_cache:
        _ctx_cache[p] = lib.ctx_new(_ptr64(ints_to_limbs([p])))
    return _ctx_cache[p]


# -- conversions --------------------------------------------------------------

def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), 4).copy()


def limbs_to_ints(arr: np.ndarray) -> List[int]:
    b = arr.astype("<u8").tobytes()
    return [int.from_bytes(b[32 * i : 32 * (i + 1)], "little") for i in range(arr.shape[0])]


def _ptr64(a: np.ndarray):
    return a.ctypes.data_as(_u64p)


def _ptr8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a)


def _point(curve, ox, oy, oinf) -> AffinePoint:
    if oinf[0]:
        return AffinePoint.identity(curve)
    return AffinePoint(curve, limbs_to_ints(ox.reshape(1, 4))[0],
                       limbs_to_ints(oy.reshape(1, 4))[0])


def _points(curve, ox, oy, oinf) -> List[AffinePoint]:
    xs, ys = limbs_to_ints(ox), limbs_to_ints(oy)
    return [AffinePoint.identity(curve) if oinf[i] else AffinePoint(curve, xs[i], ys[i])
            for i in range(len(xs))]


# -- curve ops ----------------------------------------------------------------

def marshal_points(points) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-time limb marshalling of an affine point list, for msm_cached."""
    xs = ints_to_limbs([p.x for p in points])
    ys = ints_to_limbs([p.y for p in points])
    inf = np.array([1 if p.infinity else 0 for p in points], dtype=np.uint8)
    return xs, ys, inf


def msm_cached(curve, arrays, scalars, indices=None) -> AffinePoint:
    """Host Pippenger MSM over pre-marshalled bases (from marshal_points),
    optionally index-selected: base i = arrays[indices[i]]. `scalars` is an
    int list or an (n, 4) limb array."""
    ctx = _ctx(curve.base.p)
    lib = _get_lib()
    xs, ys, inf = arrays
    if isinstance(scalars, np.ndarray):
        ks = _c(scalars)
        n = ks.shape[0]
    else:
        n = len(scalars)
        ks = ints_to_limbs([s % curve.scalar.p for s in scalars])
    ox = np.zeros(4, dtype=np.uint64)
    oy = np.zeros(4, dtype=np.uint64)
    oinf = np.zeros(1, dtype=np.uint8)
    if indices is None:
        assert n <= xs.shape[0]
        lib.msm(ctx, _ptr64(xs), _ptr64(ys), _ptr8(inf), _ptr64(ks), n,
                _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    else:
        idx = _c(np.asarray(indices, dtype=np.uint32))
        assert idx.shape[0] == n and (n == 0 or int(idx.max()) < xs.shape[0])
        lib.msm_idx(ctx, _ptr64(xs), _ptr64(ys), _ptr8(inf), _ptr64(ks),
                    idx.ctypes.data_as(_u32p), n, _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _point(curve, ox, oy, oinf)


def ec_fold(L, R, w1: int, w2: int) -> List[AffinePoint]:
    """[w1*L_i + w2*R_i] for commitment-key folding."""
    curve = L[0].curve
    n = len(L)
    lx, ly, li = marshal_points(L)
    rx, ry, ri = marshal_points(R)
    w1a = ints_to_limbs([w1 % curve.scalar.p])
    w2a = ints_to_limbs([w2 % curve.scalar.p])
    ox = np.zeros((n, 4), dtype=np.uint64)
    oy = np.zeros((n, 4), dtype=np.uint64)
    oinf = np.zeros(n, dtype=np.uint8)
    _get_lib().ec_fold(_ctx(curve.base.p), _ptr64(lx), _ptr64(ly), _ptr8(li),
                       _ptr64(rx), _ptr64(ry), _ptr8(ri), _ptr64(w1a), _ptr64(w2a),
                       n, _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _points(curve, ox, oy, oinf)


def ec_scale(points, k: int) -> List[AffinePoint]:
    """[k*P_i]."""
    curve = points[0].curve
    n = len(points)
    xs, ys, inf = marshal_points(points)
    ka = ints_to_limbs([k % curve.scalar.p])
    ox = np.zeros((n, 4), dtype=np.uint64)
    oy = np.zeros((n, 4), dtype=np.uint64)
    oinf = np.zeros(n, dtype=np.uint8)
    _get_lib().ec_scale(_ctx(curve.base.p), _ptr64(xs), _ptr64(ys), _ptr8(inf),
                        _ptr64(ka), n, _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _points(curve, ox, oy, oinf)


# -- limb-array field ops ((n, 4) uint64 LE in/out) ---------------------------

def vec_mulmod_l(p: int, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
    n = aa.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    _get_lib().vec_mulmod(_ctx(p), _ptr64(_c(aa)), _ptr64(_c(bb)), _ptr64(out), n)
    return out


def vec_fold_l(p: int, aa: np.ndarray, bb: np.ndarray, r1: int, r2: int) -> np.ndarray:
    """out = r1*a + r2*b elementwise."""
    n = aa.shape[0]
    rr1 = ints_to_limbs([r1 % p])
    rr2 = ints_to_limbs([r2 % p])
    out = np.zeros((n, 4), dtype=np.uint64)
    _get_lib().vec_fold(_ctx(p), _ptr64(_c(aa)), _ptr64(_c(bb)), _ptr64(rr1),
                        _ptr64(rr2), _ptr64(out), n)
    return out


def vec_axpy_l(p: int, aa: np.ndarray, bb: np.ndarray, s: int) -> np.ndarray:
    """out = a + s*b elementwise."""
    n = aa.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    ss = ints_to_limbs([s % p])
    _get_lib().vec_axpy(_ctx(p), _ptr64(_c(aa)), _ptr64(_c(bb)), _ptr64(ss),
                        _ptr64(out), n)
    return out


def vec_bind_l(p: int, arr: np.ndarray, r: int) -> np.ndarray:
    """Bind the top variable: out = lo + r*(hi - lo) = (1-r)*lo + r*hi."""
    half = arr.shape[0] // 2
    return vec_fold_l(p, arr[:half], arr[half:], (1 - r) % p, r % p)


def vec_dot_l(p: int, aa: np.ndarray, bb: np.ndarray) -> int:
    n = aa.shape[0]
    assert bb.shape[0] == n
    out = np.zeros((1, 4), dtype=np.uint64)
    _get_lib().vec_dot(_ctx(p), _ptr64(_c(aa)), _ptr64(_c(bb)), _ptr64(out), n)
    return limbs_to_ints(out)[0]


def vec_batch_inv_l(p: int, aa: np.ndarray) -> np.ndarray:
    """Batch modular inverse; zeros map to zero."""
    n = aa.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    _get_lib().vec_batch_inv(_ctx(p), _ptr64(_c(aa)), _ptr64(out), n)
    return out


def batch_inv_ints(p: int, vals) -> list:
    return limbs_to_ints(vec_batch_inv_l(p, ints_to_limbs([v % p for v in vals])))


def marshal_matrix(p: int, data, indices, indptr):
    """One-time native rep of a CSR matrix: Montgomery-form coefficients
    with +-1 coefficient classes (reference PrecomputedSparseMatrix,
    src/r1cs/sparse.rs:19-107)."""
    r1 = pow(2, 256, p)
    dl = ints_to_limbs([x % p for x in data])
    dm = vec_mulmod_l(p, dl, ints_to_limbs([r1] * len(data)))
    cls = np.zeros(len(data), dtype=np.uint8)
    for i, x in enumerate(data):
        v = x % p
        if v == 1:
            cls[i] = 1
        elif v == p - 1:
            cls[i] = 2
    idx = _c(np.asarray(indices, dtype=np.uint32))
    ptr = _c(np.asarray(indptr, dtype=np.uint32))
    return (dm, cls, idx, ptr, len(indptr) - 1)


def spmv_l(p: int, cache, z: np.ndarray) -> np.ndarray:
    dm, cls, idx, ptr, rows = cache
    out = np.zeros((rows, 4), dtype=np.uint64)
    _get_lib().spmv(_ctx(p), _ptr64(dm), _ptr8(cls), idx.ctypes.data_as(_u32p),
                    ptr.ctypes.data_as(_u32p), rows, _ptr64(_c(z)), _ptr64(out))
    return out


def eq_evals_l(p: int, r: Sequence[int]) -> np.ndarray:
    """Full eq(r, x) table as (2^k, 4) limbs (top variable = r[0])."""
    k = len(r)
    rl = ints_to_limbs([x % p for x in r])
    out = np.zeros((1 << k, 4), dtype=np.uint64)
    _get_lib().eq_evals(_ctx(p), _ptr64(rl), k, _ptr64(out))
    return out


def _round(name: str, p: int, k: int, tables, half: int) -> tuple:
    out = np.zeros((k, 4), dtype=np.uint64)
    getattr(_get_lib(), name)(_ctx(p), *(_ptr64(_c(t)) for t in tables), half, _ptr64(out))
    return tuple(limbs_to_ints(out))


def sumcheck_cubic_round_l(p: int, E, A, B, Cv) -> tuple:
    """(e0, cubic_coeff, e_minus_1) for one round; inputs (2h, 4) limbs."""
    return _round("sumcheck_cubic_round", p, 3, (E, A, B, Cv), E.shape[0] // 2)


def sumcheck_quad_round_l(p: int, A, B) -> tuple:
    """(e0, quad_coeff) for one round; inputs (2h, 4) limbs."""
    return _round("sumcheck_quad_round", p, 2, (A, B), A.shape[0] // 2)


def sumcheck_cubic_gruen_round_l(p: int, E, A, B, Cv) -> tuple:
    """(t0, tinf) of the eq-factored round; E is the UNBOUND prefix slice
    of the full eq table (length half), A/B/Cv the bound tables (2*half)."""
    half = A.shape[0] // 2
    assert E.shape[0] == half
    return _round("sumcheck_cubic_gruen_round", p, 2, (E, A, B, Cv), half)


# -- the rest of the JAX package's binding ------------------------------------

def _zeros(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (np.zeros((n, 4), dtype=np.uint64), np.zeros((n, 4), dtype=np.uint64),
            np.zeros(n, dtype=np.uint8))


def msm(scalars: Sequence[int], points) -> AffinePoint:
    """Host Pippenger MSM in C++ (normal-form ints in and out)."""
    curve = points[0].curve
    assert len(scalars) == len(points)
    return msm_cached(curve, marshal_points(points), list(scalars))


def batch_add_seg(curve, arrays, order, seg_off) -> List[AffinePoint]:
    """Segmented batch add over pre-marshalled points: result s is the sum
    of arrays[order[seg_off[s]:seg_off[s+1]]], all segments reduced together
    by the shared-inversion batched-affine pair scheduler (the reference's
    batch_add, src/provider/msm.rs:689-770)."""
    xs, ys, inf = arrays
    order_arr = _c(np.asarray(order, dtype=np.uint32))
    off_arr = _c(np.asarray(seg_off, dtype=np.uint32))
    nseg = off_arr.shape[0] - 1
    assert nseg >= 1 and off_arr[-1] == order_arr.shape[0]
    ox, oy, oinf = _zeros(nseg)
    _get_lib().batch_add_seg(_ctx(curve.base.p), _ptr64(xs), _ptr64(ys), _ptr8(inf),
                             order_arr.ctypes.data_as(_u32p),
                             off_arr.ctypes.data_as(_u32p), nseg,
                             _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _points(curve, ox, oy, oinf)


def ec_fixed_mul_many(base, scalars) -> List[AffinePoint]:
    """[k * base for k in scalars] with one shared fixed-base window table
    (reference fixed_base_exp_comb_batch, hyperkzg.rs:443)."""
    curve = base.curve
    n = len(scalars)
    gx, gy = ints_to_limbs([base.x]), ints_to_limbs([base.y])
    ks = ints_to_limbs([s % curve.scalar.p for s in scalars])
    ox, oy, oinf = _zeros(n)
    _get_lib().ec_fixed_mul_many(_ctx(curve.base.p), _ptr64(gx), _ptr64(gy), _ptr64(ks),
                                 n, _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _points(curve, ox, oy, oinf)


def ec_mul_many(points, scalars: Sequence[int]) -> List[AffinePoint]:
    """[k_i * P_i]."""
    curve = points[0].curve
    n = len(points)
    xs, ys, inf = marshal_points(points)
    ks = ints_to_limbs([s % curve.scalar.p for s in scalars])
    ox, oy, oinf = _zeros(n)
    _get_lib().ec_mul_many(_ctx(curve.base.p), _ptr64(xs), _ptr64(ys), _ptr8(inf),
                           _ptr64(ks), n, _ptr64(ox), _ptr64(oy), _ptr8(oinf))
    return _points(curve, ox, oy, oinf)


def vec_mulmod(p: int, a: Sequence[int], b: Sequence[int]) -> List[int]:
    return limbs_to_ints(vec_mulmod_l(p, ints_to_limbs([x % p for x in a]),
                                      ints_to_limbs([x % p for x in b])))


def vec_invmod(p: int, a: Sequence[int]) -> List[int]:
    n = len(a)
    aa = ints_to_limbs([x % p for x in a])
    out = np.zeros((n, 4), dtype=np.uint64)
    _get_lib().vec_invmod(_ctx(p), _ptr64(aa), _ptr64(out), n)
    return limbs_to_ints(out)


def vec_addmod_l(p: int, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
    n = aa.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    _get_lib().vec_addmod(_ctx(p), _ptr64(_c(aa)), _ptr64(_c(bb)), _ptr64(out), n)
    return out


def vec_cross_l(p: int, az, bz, cz, e, u: int) -> np.ndarray:
    """The cross-term az*bz - u*cz - e, elementwise."""
    n = az.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    uu = ints_to_limbs([u % p])
    _get_lib().vec_cross(_ctx(p), *(_ptr64(_c(t)) for t in (az, bz, cz, e)),
                         _ptr64(uu), _ptr64(out), n)
    return out


def vec_cross_relaxed_l(p: int, az1, bz1, cz1, az2, bz2, cz2, e1, e2,
                        u1: int, u2: int) -> np.ndarray:
    n = az1.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    uu1, uu2 = ints_to_limbs([u1 % p]), ints_to_limbs([u2 % p])
    _get_lib().vec_cross_relaxed(
        _ctx(p), *(_ptr64(_c(t)) for t in (az1, bz1, cz1, az2, bz2, cz2, e1, e2)),
        _ptr64(uu1), _ptr64(uu2), _ptr64(out), n)
    return out


def vec_sat_check_l(p: int, az, bz, cz, e, u: int) -> int:
    """Count of rows where az*bz - u*cz - e != 0."""
    uu = ints_to_limbs([u % p])
    return int(_get_lib().vec_sat_check(_ctx(p), *(_ptr64(_c(t)) for t in (az, bz, cz, e)),
                                        _ptr64(uu), az.shape[0]))


def vec_from_mont_l(p: int, aa: np.ndarray) -> np.ndarray:
    """Montgomery -> normal form on (n, 4) uint64 limbs (one REDC each)."""
    a = _c(aa)
    out = np.empty_like(a)
    _get_lib().vec_from_mont(_ctx(p), _ptr64(a), _ptr64(out), a.shape[0])
    return out


_inv_in = np.zeros(4, dtype=np.uint64)
_inv_out = np.zeros(4, dtype=np.uint64)
_inv_ptrs = None


def inv_mod(p: int, a: int) -> int:
    """Scalar modular inverse through the native kernel (xgcd). It reuses
    static buffers: single-threaded, like the rest of the frontend."""
    global _inv_ptrs
    ctx = _ctx(p)
    if _inv_ptrs is None:
        _inv_ptrs = (_ptr64(_inv_in), _ptr64(_inv_out))
    a %= p
    _inv_in[0] = a & 0xFFFFFFFFFFFFFFFF
    _inv_in[1] = (a >> 64) & 0xFFFFFFFFFFFFFFFF
    _inv_in[2] = (a >> 128) & 0xFFFFFFFFFFFFFFFF
    _inv_in[3] = a >> 192
    _get_lib().inv_mod(ctx, *_inv_ptrs)
    o = _inv_out
    return int(o[0]) | (int(o[1]) << 64) | (int(o[2]) << 128) | (int(o[3]) << 192)


def sumcheck_cubicprod_round_l(p: int, A, B, Cv) -> tuple:
    return _round("sumcheck_cubicprod_round", p, 3, (A, B, Cv), A.shape[0] // 2)


def sumcheck_quadeval_round_l(p: int, A, B) -> tuple:
    return _round("sumcheck_quadeval_round", p, 2, (A, B), A.shape[0] // 2)


def sumcheck_linear_round_l(p: int, A, B) -> tuple:
    return _round("sumcheck_linear_round", p, 2, (A, B), A.shape[0] // 2)


def neutron_round_l(p: int, e1, e2, Az1, Bz1, Cz1, Az2, Bz2, Cz2,
                    left: int, right: int) -> list:
    """Neutron NIFS 5-point round sums (before the eq factor)."""
    out = np.zeros((5, 4), dtype=np.uint64)
    _get_lib().neutron_round(_ctx(p), *(_ptr64(_c(t)) for t in
                                        (e1, e2, Az1, Bz1, Cz1, Az2, Bz2, Cz2)),
                             left, right, _ptr64(out))
    return limbs_to_ints(out)


def poly_eval_horner_l(p: int, f: np.ndarray, u: int) -> int:
    """f(u) by Horner over a limb coefficient array (f[0] lowest degree)."""
    ff = _c(f)
    ua = ints_to_limbs([u % p])
    out = np.zeros((1, 4), dtype=np.uint64)
    _get_lib().poly_eval_horner(_ctx(p), _ptr64(ff), ff.shape[0], _ptr64(ua), _ptr64(out))
    return limbs_to_ints(out)[0]


def poly_div_linear_l(p: int, f: np.ndarray, u: int) -> np.ndarray:
    """Quotient h = f // (x - u) (synthetic division), limb arrays."""
    ff = _c(f)
    n = ff.shape[0]
    assert n >= 2
    ua = ints_to_limbs([u % p])
    out = np.zeros((n - 1, 4), dtype=np.uint64)
    _get_lib().poly_div_linear(_ctx(p), _ptr64(ff), n, _ptr64(ua), _ptr64(out))
    return out


def ntt_l(p: int, a: np.ndarray, root: int, invert: bool = False) -> np.ndarray:
    """Radix-2 NTT over 2^k limb entries, on a copy; `root` is a primitive
    n-th root of unity. invert=True includes the 1/n scale."""
    aa = _c(a).copy()
    n = aa.shape[0]
    assert n & (n - 1) == 0
    ra = ints_to_limbs([root % p])
    _get_lib().ntt(_ctx(p), _ptr64(aa), n, _ptr64(ra), 1 if invert else 0)
    return aa


def keccak_f1600_lanes(lanes):
    """keccak-f[1600] on a 5x5 lane list ([x][y]) through the C kernel."""
    a = np.array([lanes[x][y] for x in range(5) for y in range(5)], dtype=np.uint64)
    _get_lib().keccak_f1600(_ptr64(a))
    return [[int(a[x * 5 + y]) for y in range(5)] for x in range(5)]


_poseidon_ctx_cache: dict = {}


def poseidon_ctx(p: int, width: int, half_full: int, partial: int,
                 crc, m, pre_sparse, sparse_matrixes):
    """Native Poseidon permutation context. Contexts live as long as the
    process; they are cached by a key drawn from the constants, matrices
    included, so bundles that differ only there do not share one."""
    key = (p, width, half_full, partial, len(crc), crc[0], crc[-1],
           m[0][0], pre_sparse[0][0], len(sparse_matrixes),
           sparse_matrixes[0][0][0] if sparse_matrixes else 0)
    h = _poseidon_ctx_cache.get(key)
    if h is not None:
        return h
    crc_l = ints_to_limbs([x % p for x in crc])
    m_l = ints_to_limbs([m[i][j] % p for i in range(width) for j in range(width)])
    pre_l = ints_to_limbs([pre_sparse[i][j] % p for i in range(width) for j in range(width)])
    w_hats = [x % p for w_hat, _ in sparse_matrixes for x in w_hat]
    v_rests = [x % p for _, v_rest in sparse_matrixes for x in v_rest]
    wh_l = ints_to_limbs(w_hats) if w_hats else np.zeros((1, 4), dtype=np.uint64)
    vr_l = ints_to_limbs(v_rests) if v_rests else np.zeros((1, 4), dtype=np.uint64)
    h = _get_lib().poseidon_ctx_new(_ctx(p), width, half_full, partial, _ptr64(crc_l),
                                    len(crc), _ptr64(m_l), _ptr64(pre_l), _ptr64(wh_l),
                                    _ptr64(vr_l))
    _poseidon_ctx_cache[key] = h
    return h


def poseidon_permute(handle, p: int, elements, width: int = None) -> list:
    if width is not None:
        # the C kernel reads and writes exactly `width` rows
        assert len(elements) == width, (len(elements), width)
    el = ints_to_limbs([x % p for x in elements])
    _get_lib().poseidon_permute(handle, _ptr64(el))
    return limbs_to_ints(el)


def poseidon_permute_witness(handle, p: int, elements, width: int,
                             full_rounds: int, partial: int, compact: bool) -> tuple:
    """(final_state, alloc_values) of one permutation, the allocations in
    the order of the circuit gadget's flat witness plan."""
    assert len(elements) == width, (len(elements), width)
    el = ints_to_limbs([x % p for x in elements])
    cap = 3 * (width * full_rounds + partial) + (partial * (width - 1) if compact else 0)
    allocs = np.zeros((cap, 4), dtype=np.uint64)
    na = _get_lib().poseidon_permute_witness(handle, _ptr64(el), _ptr64(allocs),
                                             1 if compact else 0)
    assert na <= cap, (na, cap)
    return limbs_to_ints(el), limbs_to_ints(allocs[:na])
