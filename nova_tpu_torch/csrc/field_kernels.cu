// K1-K3: elementwise field and point kernels, one thread per element.
//
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

// K1 replaces nova_tpu/fields/pallas_kernels.py::_mont_mul_2d (a*b*R^-1 mod p
// on 16-bit limbs). Bound on this card: bytes. A product is 264 32-bit
// multiply-adds against 192 B moved (two 64 B operands in, 64 B out, in the
// 16-bit-limb layout), or 128 B where one operand is a single row, below
// the ~5 int32 operations per byte at which the H100 turns compute-bound.
// A block of K1_T threads owns K1_T consecutive rows: it copies each full
// operand's 16 KB of rows into shared memory with coalesced 16 B loads
// (consecutive threads, consecutive addresses), each thread computes its
// row's product (field.cuh's carry-chain fe_mul) in registers, and the
// results leave through shared memory the same way. A row's four 16 B
// pieces sit at slots 4r + (q ^ ((r >> 1) & 3)), so a quarter-warp's
// per-row reads and the coalesced copies both hit distinct banks. An
// operand that is one row for every element (a constant: from_mont's 1, an
// axpy's or a sumcheck bind's scalar) is flagged by the wrapper and read
// once a block, so no copy of it is ever written. On NVIDIA H100 80GB HBM3,
// 700.00 W (nova_tpu_torch/perf/bucket_stage.py, device time): 0.068-0.069
// ms at 2^20 rows against its 0.060 ms bound (0.071-0.072 ms with the
// 64-bit product and a thread's own 16 B loads); at the broadcast sites,
// e.g. from_mont of 2^16 scalars, 0.0039 ms against 0.0025 ms, where a copy
// of the constant and the kernel took 0.0092 ms.
constexpr int K1_T = 256;

__device__ __forceinline__ int k1_slot(int r, int q) { return 4 * r + (q ^ ((r >> 1) & 3)); }

// rows [base, base + nrows) of src (16-bit limbs) into the block's slots
__device__ __forceinline__ void k1_stage_in(int4* sh, const int32_t* __restrict__ src,
                                            int64_t base, int nrows) {
  const int4* g = reinterpret_cast<const int4*>(src + base * NL);
  for (int k = threadIdx.x; k < 4 * nrows; k += K1_T) sh[k1_slot(k >> 2, k & 3)] = g[k];
}

__device__ __forceinline__ Fe k1_row(const int4* sh, int r) {
  Fe a;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int4 v = sh[k1_slot(r, q)];
    a.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    a.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return a;
}

template <bool A_ONE, bool B_ONE>
__global__ void __launch_bounds__(K1_T)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t n, FieldConsts fc) {
  __shared__ int4 sa[4 * K1_T], sb[4 * K1_T];
  __shared__ Fe row[2];
  const int64_t base = (int64_t)blockIdx.x * K1_T;
  const int nrows = (int)min((int64_t)K1_T, n - base);
  const int t = threadIdx.x;
  if (A_ONE) {
    if (t == 0) row[0] = fe_load(a);
  } else {
    k1_stage_in(sa, a, base, nrows);
  }
  if (B_ONE) {
    if (t == 1) row[1] = fe_load(b);
  } else {
    k1_stage_in(sb, b, base, nrows);
  }
  __syncthreads();
  Fe r;
  if (t < nrows) r = fe_mul(A_ONE ? row[0] : k1_row(sa, t), B_ONE ? row[1] : k1_row(sb, t), fc);
  __syncthreads();  // every row is read before sa takes the results
  if (t < nrows) {
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint32_t lo = r.w[2 * q], hi = r.w[2 * q + 1];
      sa[k1_slot(t, q)] = make_int4((int32_t)(lo & 0xFFFFu), (int32_t)(lo >> 16),
                                    (int32_t)(hi & 0xFFFFu), (int32_t)(hi >> 16));
    }
  }
  __syncthreads();
  int4* g = reinterpret_cast<int4*>(out + base * NL);
  for (int k = t; k < 4 * nrows; k += K1_T) g[k] = sa[k1_slot(k >> 2, k & 3)];
}

// K2 replaces pallas_kernels.py::_xyzz_add_call (complete XYZZ add). Bound:
// near the balance point (14 products, 3,696 multiply-adds, against 768 B
// moved), and where an operand is the identity the add is a copy. So a
// block first settles its lanes with an identity operand (P = 0 gives Q,
// Q = 0 gives P: plain 16 B copies of the surviving rows), then compacts
// the lanes whose operands are both live into a list (a warp ballot and a
// prefix count, as B6 does) and runs the complete formula, with its
// doubling and P = -Q cases, only on that list: thread t takes entry t,
// and warps past the list's end finish after the copies. The values
// selected are those of xyzz_add_limbs, so outputs are bit-identical. On
// NVIDIA H100 80GB HBM3, 700.00 W (nova_tpu_torch/perf/bucket_stage.py,
// device time) a commit's two 2^15-row adds (78% and 12% of lanes live)
// take 0.0168 and 0.0146 ms against a 0.0075 ms bound (bytes), where every
// lane computing the formula took 0.0206 ms each: with ~8 warps an SM the
// time is one add's latency plus the loads. Splitting a live add over four
// threads (shuffling operands between its four product levels) took 0.0174
// and 0.0118 ms: slower where most lanes are live, so it is not used.
constexpr int ADD_T = 128;
constexpr int ADD_WARPS = ADD_T / 32;

__global__ void __launch_bounds__(ADD_T)
xyzz_add_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                const int32_t* __restrict__ qzz, const int32_t* __restrict__ qzzz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int64_t n,
                FieldConsts fc) {
  __shared__ int list[ADD_T];
  __shared__ int warp_count[ADD_WARPS];
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int64_t base = (int64_t)blockIdx.x * ADD_T;
  const int64_t i = base + t;
  bool live = false;
  if (i < n) {
    const bool pz = row_is_zero(pzz + i * NL);
    const bool qz = row_is_zero(qzz + i * NL);
    live = !pz && !qz;
    if (pz)  // the identity cases of xyzz_add_limbs: P = 0 gives Q
      pt_copy(ox, oy, ozz, ozzz, i, qx, qy, qzz, qzzz, i);
    else if (qz)
      pt_copy(ox, oy, ozz, ozzz, i, px, py, pzz, pzzz, i);
  }
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, live);
  if (wl == 0) warp_count[warp] = __popc(bal);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < ADD_WARPS; w++) {
    const int c = warp_count[w];
    if (w < warp) before += c;
    count += c;
  }
  if (live) list[before + __popc(bal & ((1u << wl) - 1u))] = t;
  __syncthreads();
  if (t >= count) return;
  const int64_t j = base + list[t];
  const Pt P = pt_load(px, py, pzz, pzzz, j);
  const Pt Q = pt_load(qx, qy, qzz, qzzz, j);
  pt_store(ox, oy, ozz, ozzz, j, xyzz_add_live(P, Q, fc));
}

// K3 replaces pallas_kernels.py::_xyzz_double_call (dbl-2008-s-1, a = 0),
// with `times` chained doublings in one launch: a key's window precompute
// doubles every base c times a window (ops/msm2.py::_precompute_shifted),
// and one launch a window loads each row once, runs the c doublings in
// registers and stores once, where c launches of one doubling moved the
// row in and out c times. Bound on this card: operations (9 products a
// doubling, 2,376 multiply-adds, against 512 B a row for the whole chain).
// Every step keeps the identity test, so a row whose ZZ reaches 0 midway
// (Y = 0) is copied by the steps after it, as `times` launches of one
// doubling would leave it: the output is theirs bit for bit. One thread a
// row: 2^16 rows make 512 blocks of 128 threads, 3 or 4 an SM, so no SM
// holds more than 16 warps, the least that any split of 2,048 warps over
// 132 SMs allows; at most 128 registers (it takes 128, no spills) keep
// four such blocks resident. On NVIDIA H100 80GB HBM3, 700.00 W
// (nova_tpu_torch/perf/bucket_stage.py, device time) a window takes
// 0.181 ms at 2^16 rows x 16 doublings against its 0.149 ms bound, and
// 0.309 ms at 2^17 x 14 against 0.261 ms, where one launch a doubling took
// 0.330-0.333 and 0.428-0.440 ms.
constexpr int DBL_T = 128;

__global__ void __launch_bounds__(DBL_T, 4)
xyzz_double_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int64_t n,
                   int times, FieldConsts fc) {
  const int64_t i = (int64_t)blockIdx.x * DBL_T + threadIdx.x;
  if (i >= n) return;
  Pt P = pt_load(px, py, pzz, pzzz, i);
  for (int k = 0; k < times; k++) P = xyzz_double(P, fc);
  pt_store(ox, oy, ozz, ozzz, i, P);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* nt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a_one / b_one: the operand is one row, the same for every element
int nt_mont_mul(const void* a, const void* b, void* out, int64_t n, int a_one,
                int b_one, const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = blocks_for(n, K1_T);
  cudaStream_t s = (cudaStream_t)stream;
  const FieldConsts fc = load_consts(consts);
  const int32_t *pa = (const int32_t*)a, *pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  if (a_one && b_one) mont_mul_kernel<true, true><<<blocks, K1_T, 0, s>>>(pa, pb, po, n, fc);
  else if (a_one) mont_mul_kernel<true, false><<<blocks, K1_T, 0, s>>>(pa, pb, po, n, fc);
  else if (b_one) mont_mul_kernel<false, true><<<blocks, K1_T, 0, s>>>(pa, pb, po, n, fc);
  else mont_mul_kernel<false, false><<<blocks, K1_T, 0, s>>>(pa, pb, po, n, fc);
  return (int)cudaGetLastError();
}

int nt_xyzz_add(const void* px, const void* py, const void* pzz, const void* pzzz,
                const void* qx, const void* qy, const void* qzz, const void* qzzz,
                void* ox, void* oy, void* ozz, void* ozzz, int64_t n,
                const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  xyzz_add_kernel<<<blocks_for(n, ADD_T), ADD_T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
      (const int32_t*)pzzz, (const int32_t*)qx, (const int32_t*)qy,
      (const int32_t*)qzz, (const int32_t*)qzzz, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)ozz, (int32_t*)ozzz, n, load_consts(consts));
  return (int)cudaGetLastError();
}

// `times` >= 1 chained doublings of each row
int nt_xyzz_double(const void* px, const void* py, const void* pzz, const void* pzzz,
                   void* ox, void* oy, void* ozz, void* ozzz, int64_t n, int times,
                   const uint32_t* consts, void* stream) {
  if (times < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  xyzz_double_kernel<<<blocks_for(n, DBL_T), DBL_T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
      (const int32_t*)pzzz, (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz,
      (int32_t*)ozzz, n, times, load_consts(consts));
  return (int)cudaGetLastError();
}

}  // extern "C"
