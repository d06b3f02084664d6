"""Build and load the port's CUDA kernels.

Route: ``nvcc`` compiles each source of ``csrc/`` for ``sm_90a`` into an
object (all sources at once, in parallel), links them into one shared
library with a plain C interface, and ``ctypes`` loads it. The library
lands in ``_build/<hash of sources and flags>/`` beside this file, a
directory that git ignores, so the first call after a change rebuilds and
later calls reuse it. ``nvcc -Xptxas -v`` output (registers, spills) is
kept in ``ptxas.log`` there.

Nothing here runs at import time: the first kernel launch calls ``lib()``.
``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
SOURCES = ("field_kernels.cu", "msm_kernels.cu", "stage_kernel.cu", "ubench_kernels.cu",
           "chain_probe.cu")
HEADERS = ("field.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libnova_tpu_torch_kernels.so"

# kernel name -> launches since the last reset_launches()
LAUNCHES = {
    "mont_mul": 0,
    "xyzz_add": 0,
    "xyzz_double": 0,
    "accum": 0,
    "bucket_reduce": 0,
    "suffix_segmented": 0,
    "stage": 0,
    "mont16_chain": 0,
    "mont8_chain": 0,
}

# filled by build(): {"dir", "seconds", "built"} of the library in use
build_info: dict = {}

_lib = None
_lock = threading.Lock()

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "nt_mont_mul": [_vp, _vp, _vp, _i64, _i32, _i32, _vp, _vp],
    "nt_xyzz_add": [_vp] * 12 + [_i64, _vp, _vp],
    "nt_xyzz_double": [_vp] * 8 + [_i64, _i32, _vp, _vp],
    "nt_accum": [_i32, _i32, _vp, _i64] + [_vp] * 10 + [_i32] + [_vp] * 5
                + [_i32, _i32, _vp, _vp],
    "nt_bucket_reduce": [_vp] * 10 + [_i32, _i32, _vp, _vp],
    "nt_suffix_buckets": [_vp] * 5 + [_i32, _i32] + [_vp] * 4 + [_i32, _vp, _vp],
    "nt_stage": [_i32, _i32] + [_vp] * 11 + [_i64, _i32, _vp, _vp],
    "nt_mont16_chain": [_vp, _vp, _vp, _i64, _i32, _vp, _vp],
    "nt_mont8_chain": [_vp, _vp, _vp, _i64, _i32, _vp, _vp],
    "nt_chain_probe": [_i32] + [_vp] * 8 + [_i32] * 4 + [_vp, _vp],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nova_tpu_torch: nvcc not found (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Path of the shared library, compiling it first if this source
    digest has not been built yet."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(so):
        build_info.update(dir=out_dir, seconds=0.0, built=False)
        return so
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    t0 = time.perf_counter()
    try:
        _compile(nvcc, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(
        dir=out_dir, seconds=time.perf_counter() - t0, built=True
    )
    return so


def _compile(nvcc: str, tmp: str) -> None:
    """All sources to objects in parallel, then one link, inside `tmp`."""
    procs = []
    for src in SOURCES:
        obj = os.path.join(tmp, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log = []
    failed = []
    for src, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    with open(os.path.join(tmp, "ptxas.log"), "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nova_tpu_torch: nvcc failed on {failed}:\n" + "\n".join(log)
        )
    objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", os.path.join(tmp, LIB_NAME)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nova_tpu_torch: link failed:\n{link.stdout}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                handle.nt_error_string.argtypes = [ctypes.c_int]
                handle.nt_error_string.restype = ctypes.c_char_p
                _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err:
        msg = lib().nt_error_string(err).decode()
        raise RuntimeError(f"nova_tpu_torch kernel {name}: CUDA error {err}: {msg}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
