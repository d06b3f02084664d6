// P1, P2: the field microbenchmark's chained Montgomery products, one
// thread per column.
//
// P1 replaces perf/ubench_field.py::mont16_chain (body mont16_kernel), P2
// replaces perf/ubench_field.py::mont8_chain (body mont8_kernel). Each
// computes exactly what its TPU body computes, odd edges included: the
// inputs are (NL, N) uint32 arrays of random NL-limb values in radix
// 2^BITS (not canonical field elements), every product is a uint32 product,
// the Montgomery reduction has no final conditional subtraction, and the
// carry out of the top limb is dropped. The ITERS loop A <- A*B*2^-256 runs
// inside the kernel, so one launch is the whole chain, as on the TPU.
//
// Bound on this card: operations. Per column and iteration P1 does 528
// 32-bit multiplies (256 limb products, 16 + 16 + 240 in the reduction) and
// P2 2,080 (1,024 + 32 + 32 + 992), each feeding an add, against 3 x NL x 4
// bytes moved once for the whole chain. The design keeps A, B and the
// 2*NL-column accumulator in registers (fully unrolled limb loops), reads
// each limb row with neighbouring threads on neighbouring columns, and
// writes A once at the end.
//
// Also the latency probe of nova_tpu_torch/perf/bucket_stage.py (no TPU
// counterpart, on no path of the program): each thread chains n complete
// adds acc <- acc + Q (mode 0, field.cuh's xyzz_add), n doublings (mode 1)
// or n Montgomery products acc <- acc * b (mode 2, field.cuh's fe_mul) on
// its own row, so one warp alone times one step's latency and a full card
// the throughput. It uses nothing of field.cuh but fe_mul, xyzz_add,
// xyzz_double and the row loads, so it also builds against an older
// field.cuh, which is how bucket_stage.py times two versions of the
// product.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

// the Pallas base field p, little-endian limbs (perf/ubench_field.py:86)
__constant__ uint32_t P16[16] = {
    0x0001u, 0x0000u, 0x30edu, 0x992du, 0xf91bu, 0x094cu, 0x98fcu, 0x2246u,
    0x0000u, 0x0000u, 0x0000u, 0x0000u, 0x0000u, 0x0000u, 0x0000u, 0x4000u};
__constant__ uint32_t P8[32] = {
    0x01u, 0x00u, 0x00u, 0x00u, 0xedu, 0x30u, 0x2du, 0x99u,
    0x1bu, 0xf9u, 0x4cu, 0x09u, 0xfcu, 0x98u, 0x46u, 0x22u,
    0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x00u,
    0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x00u, 0x40u};
// -p^-1 mod 2^16 and mod 2^8
constexpr uint32_t N0_16 = 65535u;
constexpr uint32_t N0_8 = 255u;

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// P1: radix 2^16, 16 limbs (mont16_kernel, perf/ubench_field.py:96-137)
__global__ void __launch_bounds__(THREADS)
mont16_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ o, int64_t n, int iters) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t A[16], B[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    A[i] = a[i * n + col];
    B[i] = b[i * n + col];
  }
  for (int it = 0; it < iters; ++it) {
    uint32_t cols[33];
#pragma unroll
    for (int k = 0; k < 33; ++k) cols[k] = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t t = A[i] * B[j];
        cols[i + j] += t & 0xFFFFu;
        cols[i + j + 1] += t >> 16;
      }
    }
    uint32_t carry = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t t = cols[i] + carry;
      const uint32_t m = (t * N0_16) & 0xFFFFu;  // wraps in uint32, as on the TPU
      const uint32_t pm0 = m * P16[0];
      const uint32_t tmp = t + (pm0 & 0xFFFFu);
      carry = (tmp >> 16) + (pm0 >> 16);
#pragma unroll
      for (int j = 1; j < 16; ++j) {
        const uint32_t pj = m * P16[j];
        cols[i + j] += pj & 0xFFFFu;
        cols[i + j + 1] += pj >> 16;
      }
    }
    uint32_t c = carry;
#pragma unroll
    for (int k = 16; k < 32; ++k) {
      const uint32_t v = cols[k] + c;
      A[k - 16] = v & 0xFFFFu;
      c = v >> 16;  // the carry out of the top limb is dropped
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i * n + col] = A[i];
}

// P2: radix 2^8, 32 limbs (mont8_kernel, perf/ubench_field.py:167-204)
__global__ void __launch_bounds__(THREADS)
mont8_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ o, int64_t n, int iters) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t A[32], B[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    A[i] = a[i * n + col];
    B[i] = b[i * n + col];
  }
  for (int it = 0; it < iters; ++it) {
    uint32_t cols[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) cols[k] = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int j = 0; j < 32; ++j) cols[i + j] += A[i] * B[j];
    }
    uint32_t carry = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t t = cols[i] + carry;
      const uint32_t m = (t * N0_8) & 0xFFu;
      const uint32_t tmp = t + m * P8[0];
      carry = tmp >> 8;
#pragma unroll
      for (int j = 1; j < 32; ++j) cols[i + j] += m * P8[j];
    }
    uint32_t c = carry;
#pragma unroll
    for (int k = 32; k < 64; ++k) {
      const uint32_t v = cols[k] + c;
      A[k - 32] = v & 0xFFu;
      c = v >> 8;  // dropped after the top limb
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i * n + col] = A[i];
}

template <int MODE>
__global__ void __launch_bounds__(256)
point_chain_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ zz, const int32_t* __restrict__ zzz,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int n, int rows,
                   nt::FieldConsts fc) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) % rows;
  nt::Pt A = nt::pt_load(x, y, zz, zzz, i);
  const nt::Pt Q = nt::pt_load(x, y, zz, zzz, (i + 1) % rows);
  for (int k = 0; k < n; k++) {
    if (MODE == 0) A = nt::xyzz_add(A, Q, fc);
    if (MODE == 1) A = nt::xyzz_double(A, fc);
    if (MODE == 2) A.x = nt::fe_mul(A.x, Q.y, fc);
  }
  nt::pt_store(ox, oy, ozz, ozzz, i, A);
}

}  // namespace

extern "C" {

int nt_mont16_chain(const void* a, const void* b, void* out, int64_t n, int iters,
                    void* stream) {
  if (n <= 0) return 0;
  mont16_chain_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
  return (int)cudaGetLastError();
}

int nt_mont8_chain(const void* a, const void* b, void* out, int64_t n, int iters,
                   void* stream) {
  if (n <= 0) return 0;
  mont8_chain_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters);
  return (int)cudaGetLastError();
}

int nt_chain_probe(int mode, const void* x, const void* y, const void* zz,
                   const void* zzz, void* ox, void* oy, void* ozz, void* ozzz, int n,
                   int rows, int blocks, int threads, const uint32_t* consts, void* stream) {
  if (mode < 0 || mode > 2 || rows <= 0 || blocks <= 0 || threads <= 0 || threads > 256)
    return (int)cudaErrorInvalidValue;
  const nt::FieldConsts fc = nt::load_consts(consts);
  cudaStream_t s = (cudaStream_t)stream;
#define NT_CHAIN_ARGS                                                                   \
  (const int32_t*)x, (const int32_t*)y, (const int32_t*)zz, (const int32_t*)zzz,        \
      (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, n, rows, fc
  if (mode == 0) point_chain_kernel<0><<<blocks, threads, 0, s>>>(NT_CHAIN_ARGS);
  if (mode == 1) point_chain_kernel<1><<<blocks, threads, 0, s>>>(NT_CHAIN_ARGS);
  if (mode == 2) point_chain_kernel<2><<<blocks, threads, 0, s>>>(NT_CHAIN_ARGS);
#undef NT_CHAIN_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
