"""Field-arithmetic microbenchmark (port of ``perf/ubench_field.py``).

Kernels P1 (``mont16_chain``, radix 2^16) and P2 (``mont8_chain``, radix
2^8): ITERS chained Montgomery products A <- A*B*2^-256 over the Pallas
base field, one column per element, in ``(NL, N)`` limb layout. Both
compute one function, the TPU bodies' odd edges included: random limbs
rather than canonical elements, no final conditional subtraction, the top
carry dropped, so each step is A <- ((A*B + M*p) / 2^256) mod 2^256 with
M = -A*B*p^-1 mod 2^256. On CUDA tensors each wrapper launches
``csrc/ubench_kernels.cu``'s ``mont_chain_kernel`` in its radix (or
raises): the limbs packed into 32-bit words and the chain run with the
port's carry-chain product, its field constants those of
``fields/spec.py``'s Pallas base (the same as K1's). That kernel takes
limbs below 2^BITS, as ``inputs`` makes them, and does not check them. On
CPU tensors each wrapper runs its plain PyTorch version, the TPU body's
radix-2^BITS columns on int64 lanes.

The raw probes (``raw_mul_chain``, ``raw_mulmask_chain``, ``raw_f32_chain``)
are XLA programs in the JAX package and stay plain PyTorch here.

Run on the card: ``python -m nova_tpu_torch.perf.ubench_field [N_LOG2] [ITERS]``
(defaults 18 and 20).

Replaces: ``perf/ubench_field.py::mont16_chain`` (P1) and ``::mont8_chain``
(P2).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from nova_tpu_torch import _build
from nova_tpu_torch._device import on_cuda, resolve
from nova_tpu_torch.fields.spec import pallas_base
from nova_tpu_torch.fields.tfield import TField

N_LOG2, ITERS = 18, 20

# the Pallas base field (perf/ubench_field.py:86)
P = 0x40000000000000000000000000000000224698fc094cf91b992d30ed00000001
U32 = 0xFFFFFFFF


def _limbs(bits: int):
    nl = 256 // bits
    return [(P >> (bits * i)) & ((1 << bits) - 1) for i in range(nl)]


def _n0(bits: int) -> int:
    return (-pow(P, -1, 1 << bits)) % (1 << bits)


# ---------------------------------------------------------------------------
# plain versions: the TPU bodies on (NL, N) int64 lanes
# ---------------------------------------------------------------------------


def _mont_step16(A, B, p, n0):
    """One mont16_kernel product (perf/ubench_field.py:102-127) on (16, N)
    int64 tensors of 16-bit limbs. Every column stays below 2^32, so only
    t * n0 wraps in the TPU's uint32; its low 16 bits, all that is kept,
    are reproduced by the wrap to 32 bits."""
    mask = 0xFFFF
    prod = A[:, None, :] * B[None, :, :]  # (i, j, N): A_i * B_j < 2^32
    lo, hi = prod & mask, prod >> 16
    cols = A.new_zeros((33,) + A.shape[1:])
    for i in range(16):
        cols[i : i + 16] += lo[i]
        cols[i + 1 : i + 17] += hi[i]
    carry = torch.zeros_like(A[0])
    for i in range(16):
        t = cols[i] + carry
        m = ((t * n0) & U32) & mask
        pm0 = m * p[0]
        tmp = t + (pm0 & mask)
        carry = (tmp >> 16) + (pm0 >> 16)
        pj = m[None] * p[1:, None]
        cols[i + 1 : i + 16] += pj & mask
        cols[i + 2 : i + 17] += pj >> 16
    out = []
    c = carry
    for k in range(16, 32):
        v = cols[k] + c
        out.append(v & mask)
        c = v >> 16
    return torch.stack(out)


def _mont_step8(A, B, p, n0):
    """One mont8_kernel product (perf/ubench_field.py:174-194) on (32, N)
    int64 tensors of 8-bit limbs (columns below 2^23: nothing wraps)."""
    mask = 0xFF
    prod = A[:, None, :] * B[None, :, :]
    cols = A.new_zeros((64,) + A.shape[1:])
    for i in range(32):
        cols[i : i + 32] += prod[i]
    carry = torch.zeros_like(A[0])
    for i in range(32):
        t = cols[i] + carry
        m = ((t * n0) & U32) & mask
        carry = (t + m * p[0]) >> 8
        cols[i + 1 : i + 32] += m[None] * p[1:, None]
    out = []
    c = carry
    for k in range(32, 64):
        v = cols[k] + c
        out.append(v & mask)
        c = v >> 8
    return torch.stack(out)


def mont_chain_plain(a, b, iters: int, bits: int):
    """Plain P1 (bits = 16) or P2 (bits = 8): `iters` chained products of
    (NL, N) limb tensors; returns (NL, N) int32."""
    step = _mont_step16 if bits == 16 else _mont_step8
    p = torch.tensor(_limbs(bits), dtype=torch.int64, device=a.device)
    A, B = a.long(), b.long()
    for _ in range(iters):
        A = step(A, B, p, _n0(bits))
    return A.to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _chain(bits: int, a, b, iters: int):
    nl = 256 // bits
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != nl:
        raise ValueError(f"expected two ({nl}, N) limb tensors, got {a.shape}, {b.shape}")
    if not on_cuda(a, b):
        return mont_chain_plain(a, b, iters, bits)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("kernel inputs are int32")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    name = f"mont{bits}_chain"
    with torch.cuda.device(out.device):
        err = getattr(_build.lib(), f"nt_{name}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1], iters,
            TField(pallas_base).consts_ptr, _build.stream_of(out),
        )
        _build.check(err, name)
        _build.LAUNCHES[name] += 1
    return out


def mont16_chain(a, b, iters: int = ITERS):
    """P1: `iters` chained radix-2^16 Montgomery products of (16, N) int32
    tensors of 16-bit limbs."""
    return _chain(16, a, b, iters)


def mont8_chain(a, b, iters: int = ITERS):
    """P2: the same in radix 2^8 on (32, N) int32 tensors of 8-bit limbs."""
    return _chain(8, a, b, iters)


# ---------------------------------------------------------------------------
# raw probes (XLA in the JAX package): int32 lanes hold the uint32 bits
# ---------------------------------------------------------------------------


def raw_mul_chain(a, b, iters: int = ITERS):
    """64 dependent uint32 multiplies per element per iteration."""
    x = a
    for _ in range(iters):
        for _ in range(64):
            x = x * b
    return x


def raw_mulmask_chain(a, b, iters: int = ITERS):
    """uint32 multiply, mask, logical shift and add, x64 per iteration."""
    x = a
    for _ in range(iters):
        for _ in range(64):
            t = x * b
            x = (t & 0xFFFF) + ((t >> 16) & 0xFFFF)
    return x


def raw_f32_chain(a, b, iters: int = ITERS):
    x = a
    for _ in range(iters):
        for _ in range(64):
            x = x * b + a
    return x


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------


def inputs(n: int, seed: int = 0, device=None):
    """The benchmark's operands on `device` (CUDA unless given): (16, n)
    16-bit and (32, n) 8-bit limb pairs and the raw probes' flat vectors,
    drawn as the JAX benchmark draws them (b's 16-bit limbs from [1, 2^16),
    the flat multiplier odd)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    a32 = rng.integers(0, 1 << 16, (16, n), dtype=np.int64).astype(np.int32)
    b32 = rng.integers(1, 1 << 16, (16, n), dtype=np.int64).astype(np.int32)
    a8 = rng.integers(0, 256, (32, n), dtype=np.int64).astype(np.int32)
    b8 = rng.integers(0, 256, (32, n), dtype=np.int64).astype(np.int32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         (("a16", a32), ("b16", b32), ("a8", a8), ("b8", b8))}
    t["flat_a"] = t["a16"].reshape(-1)[:n].clone()
    t["flat_b"] = t["b16"].reshape(-1)[:n] | 1
    return t


def timeit(name, fn, *args, work_per_elem=1, elems, iters=ITERS):
    """Time one call after a warm-up (CUDA events on the card); prints the
    JAX benchmark's line and returns seconds per iteration."""
    fn(*args)
    cuda = args[0].is_cuda
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        fn(*args)
        dt = (time.perf_counter() - t0) / iters
    rate = elems / dt
    print(f"{name:48s} {dt*1e3:8.3f} ms/iter  {rate/1e6:10.2f} M elem/s  "
          f"{rate*work_per_elem/1e9:8.1f} G op/s")
    return dt


def main(argv=None, device=None) -> dict:
    """The JAX benchmark's lines on `device` (CUDA unless given); returns
    {name: seconds per iteration}."""
    argv = sys.argv[1:] if argv is None else argv
    n = 1 << (int(argv[0]) if argv else N_LOG2)
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    dev = resolve(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} ({name}) N=2^{n.bit_length()-1} "
          f"iters={iters} (x64 inner for raw probes)")
    t = inputs(n, device=dev)
    out = {}
    out["raw_mul"] = timeit("raw u32 mul x64 (torch)", raw_mul_chain, t["flat_a"],
                            t["flat_b"], iters, work_per_elem=64 * iters, elems=n,
                            iters=iters)
    out["raw_mulmask"] = timeit("raw u32 mul+mask+shift+add x64 (torch)",
                                raw_mulmask_chain, t["flat_a"], t["flat_b"], iters,
                                work_per_elem=64 * iters, elems=n, iters=iters)
    af = t["flat_a"].float()
    bf = t["flat_b"].float() / 65536.0
    out["raw_f32"] = timeit("raw f32 fma x64 (torch)", raw_f32_chain, af, bf, iters,
                            work_per_elem=64 * iters, elems=n, iters=iters)
    out["mont16"] = timeit("mont_mul 16x16b kernel (P1)", mont16_chain, t["a16"], t["b16"],
                           iters, work_per_elem=iters, elems=n, iters=iters)
    out["mont8"] = timeit("mont_mul 32x8b kernel (P2)", mont8_chain, t["a8"], t["b8"],
                          iters, work_per_elem=iters, elems=n, iters=iters)
    return out


if __name__ == "__main__":
    main()
