// K4 (segmented bucket accumulation) and K5 (weighted bucket reduction) of
// the fixed-base MSM, nova_tpu_torch/ops/msm3.py and ops/msm2.py.
//
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

// K4 replaces nova_tpu/ops/msm3.py::_accum_call. The input is the (R, C)
// grid of points sorted by |digit|, stored row-major: grid cell (i, j) holds
// sorted position j*R + i, so each column is a contiguous run of the sorted
// order while neighbouring columns are neighbours in memory.
//
// On the TPU the grid walked column blocks in order with a VMEM accumulator.
// Here one thread owns one column and walks its R rows with the accumulator
// in registers: acc += P while the digit repeats; when it changes, acc is
// flushed to that row's slot and restarts at P. A warp's row reads and
// flush writes are 32 neighbouring 64 B cells, so they coalesce. The caller
// picks C in the tens of thousands so that the card has enough threads.
//
// Bound: integer multiply-adds of the mixed adds (10 products per repeated
// digit), against ~390 B moved per cell (point in, dense flush out). The
// complete add holds ~20 live 256-bit values, so registers are the scarce
// resource (one column per thread keeps occupancy low); the build log,
// ptxas.log, records registers, stack and spills.
//
// Encodings kept from the reference: acc starts all-zero, a flush row is
// all-zero where no run ends, digit 0 is inert, and the flag ORs
// bad & ~boundary.
template <bool AFFINE, bool FAST>
__global__ void __launch_bounds__(128)
accum_kernel(const int32_t* __restrict__ digs, const int32_t* __restrict__ px,
             const int32_t* __restrict__ py, const int32_t* __restrict__ pzz,
             const int32_t* __restrict__ pzzz, int32_t* __restrict__ fx,
             int32_t* __restrict__ fy, int32_t* __restrict__ fzz,
             int32_t* __restrict__ fzzz, int32_t* __restrict__ cx,
             int32_t* __restrict__ cy, int32_t* __restrict__ czz,
             int32_t* __restrict__ czzz, int32_t* __restrict__ flag, int R, int C,
             FieldConsts fc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C) return;
  Pt acc;
  acc.x = fe_zero();
  acc.y = fe_zero();
  acc.zz = fe_zero();
  acc.zzz = fe_zero();
  Pt none = acc;
  int prev = -1;
  bool bad_any = false;
  for (int i = 0; i < R; i++) {
    const int64_t off = (int64_t)i * C + j;
    const int d = digs[off];
    const bool boundary = d != prev;
    Pt q;
    q.x = fe_load(px + off * NL);
    q.y = fe_load(py + off * NL);
    if (AFFINE) {
      q.zz = d != 0 ? fe_one(fc) : fe_zero();
      q.zzz = q.zz;
    } else {
      q.zz = fe_load(pzz + off * NL);
      q.zzz = fe_load(pzzz + off * NL);
    }
    pt_store(fx, fy, fzz, fzzz, off, boundary ? acc : none);
    if (boundary) {
      acc = q;
    } else if (FAST) {
      bool bad;
      if (AFFINE) {
        acc = xyzz_madd_fast(acc, q.x, q.y, d != 0, bad, fc);
      } else {
        acc = xyzz_add_fast(acc, q, bad, fc);
      }
      bad_any |= bad;
    } else {
      acc = xyzz_add(acc, q, fc);
    }
    prev = d;
  }
  pt_store(cx, cy, czz, czzz, j, acc);
  flag[j] = bad_any ? 1 : 0;
}

// K5 replaces nova_tpu/ops/msm2.py::_bucket_reduce_call. One block per group
// of m buckets (m threads, one bucket each). For group g it writes
//   S_g = sum_j T[g*m + j]        and    W_g = sum_j (j+1) * T[g*m + j]
// by two Hillis-Steele suffix passes of complete adds: in round r lane j
// adds lane (j + 2^r) mod m, whose ZZ reads as zero when j + 2^r >= m. S is
// lane 0 after the first log2(m) rounds, W lane 0 after all 2*log2(m).
// The partner exchange goes through shared memory (m * 128 B, 32 KB at
// m = 256), one point per thread per round.
//
// Bound: integer multiply-adds of the 2*log2(m)*nb complete adds; the table
// is read once and only 2 points per group are written.
__global__ void __launch_bounds__(256)
bucket_reduce_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                     const int32_t* __restrict__ tzz, const int32_t* __restrict__ tzzz,
                     int32_t* __restrict__ sx, int32_t* __restrict__ sy,
                     int32_t* __restrict__ szz, int32_t* __restrict__ szzz,
                     int32_t* __restrict__ wx, int32_t* __restrict__ wy,
                     int32_t* __restrict__ wzz, int32_t* __restrict__ wzzz, int m,
                     int logm, FieldConsts fc) {
  extern __shared__ Pt lanes[];
  const int g = blockIdx.x;
  const int j = threadIdx.x;
  Pt P = pt_load(tx, ty, tzz, tzzz, (int64_t)g * m + j);
  for (int r2 = 0; r2 < 2 * logm; r2++) {
    if (r2 == logm && j == 0) pt_store(sx, sy, szz, szzz, g, P);
    const int src = j + (1 << (r2 % logm));
    lanes[j] = P;
    __syncthreads();
    Pt Q = lanes[src & (m - 1)];
    __syncthreads();
    if (src >= m) Q.zz = fe_zero();
    P = xyzz_add(P, Q, fc);
  }
  if (j == 0) pt_store(wx, wy, wzz, wzzz, g, P);
}

}  // namespace

extern "C" {

int nt_accum(int affine, int fast, const void* digs, const void* px, const void* py,
             const void* pzz, const void* pzzz, void* fx, void* fy, void* fzz,
             void* fzzz, void* cx, void* cy, void* czz, void* czzz, void* flag, int R,
             int C, const uint32_t* consts, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const FieldConsts fc = load_consts(consts);
  const dim3 grid((C + 127) / 128), block(128);
  cudaStream_t s = (cudaStream_t)stream;
#define NT_ACCUM_ARGS                                                              \
  (const int32_t*)digs, (const int32_t*)px, (const int32_t*)py,                    \
      (const int32_t*)pzz, (const int32_t*)pzzz, (int32_t*)fx, (int32_t*)fy,       \
      (int32_t*)fzz, (int32_t*)fzzz, (int32_t*)cx, (int32_t*)cy, (int32_t*)czz,    \
      (int32_t*)czzz, (int32_t*)flag, R, C, fc
  if (affine && fast) {
    accum_kernel<true, true><<<grid, block, 0, s>>>(NT_ACCUM_ARGS);
  } else if (affine) {
    accum_kernel<true, false><<<grid, block, 0, s>>>(NT_ACCUM_ARGS);
  } else if (!fast) {
    accum_kernel<false, false><<<grid, block, 0, s>>>(NT_ACCUM_ARGS);
  } else {
    accum_kernel<false, true><<<grid, block, 0, s>>>(NT_ACCUM_ARGS);
  }
#undef NT_ACCUM_ARGS
  return (int)cudaGetLastError();
}

int nt_bucket_reduce(const void* tx, const void* ty, const void* tzz, const void* tzzz,
                     void* sx, void* sy, void* szz, void* szzz, void* wx, void* wy,
                     void* wzz, void* wzzz, int64_t groups, int m,
                     const uint32_t* consts, void* stream) {
  if (groups <= 0) return 0;
  if (m < 2 || m > 256 || (m & (m - 1)) != 0) return (int)cudaErrorInvalidValue;
  int logm = 0;
  while ((1 << logm) < m) logm++;
  bucket_reduce_kernel<<<(unsigned)groups, m, m * sizeof(Pt), (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tzz,
      (const int32_t*)tzzz, (int32_t*)sx, (int32_t*)sy, (int32_t*)szz,
      (int32_t*)szzz, (int32_t*)wx, (int32_t*)wy, (int32_t*)wzz, (int32_t*)wzzz, m,
      logm, load_consts(consts));
  return (int)cudaGetLastError();
}

}  // extern "C"
