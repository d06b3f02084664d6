// K4 (segmented bucket accumulation) and K5 (weighted bucket reduction) of
// the fixed-base MSM, nova_tpu_torch/ops/msm3.py and ops/msm2.py.
//
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

// K4 replaces nova_tpu/ops/msm3.py::_accum_call followed by the tail
// selection of _bucket_totals. The input is a sequence of n = R*C cells in
// sorted digit order, laid on an (R, C) grid column by column: column j
// holds positions j*R .. j*R + R-1. Cell p has the digit dig[p * dstride]
// (non-decreasing in p; a stride lets level 2 read the column-end digits of
// level 1 in place) and its point at row s = src[p] of the point arrays
// (s = p without src): affine x and y, with y read from yneg where
// signs[s] < 0, or XYZZ x/y/zz/zzz.
//
// One thread walks one column with the accumulator in registers: acc += P
// while the digit repeats; where it changes, acc is the total of the run
// that just ended, and is written to row d - 1 of the (nb, 16) tail table
// when that run's digit d > 0, and acc restarts at P. A run that reaches
// the end of its column is the column's carry (colend) instead. The digits
// are sorted, so each bucket's run ends at one position: the table has one
// writer per row, and the caller zeroes it. Digit 0 is inert: its cells
// read no point and leave the identity (all zero). The fast modes flag
// bad & ~boundary per column.
//
// On the TPU the kernel took a point grid that a sort and gathers had laid
// out and wrote a dense (R, C) flush; here the kernel reads the base rows by
// index itself and writes only the run tails, so no point grid exists and
// ~nb + C of the R*C cells are written instead of all of them. A block
// stages its columns' digits and indices through shared memory, ACC_ROWS
// rows at a time (a warp reads 32 contiguous positions), padded so that the
// column walks read distinct banks. The next live cell's base rows are
// loaded before the current add, so the gather latency overlaps the
// arithmetic.
//
// Bound: integer multiply-adds of the mixed adds (10 products per repeated
// digit) against ~150 B read per cell (a 128 B base row, the digit, the
// index, the sign). One column per thread: C sets the parallelism, so the
// card holds few warps and each column is a dependent chain; ptxas.log
// records registers, stack and spills.
constexpr int ACC_T = 128;
constexpr int ACC_ROWS = 32;
constexpr int ACC_PITCH = ACC_ROWS + 1;

// The raw (16-bit limb) rows of one cell's point, loaded ahead of use.
template <bool AFFINE>
struct Raw {
  int4 v[AFFINE ? 8 : 16];
};

template <bool AFFINE>
__device__ __forceinline__ void raw_load(Raw<AFFINE>& r, const int32_t* __restrict__ px,
                                         const int32_t* __restrict__ py,
                                         const int32_t* __restrict__ pyneg,
                                         const int32_t* __restrict__ pzz,
                                         const int32_t* __restrict__ pzzz,
                                         const int32_t* __restrict__ signs, int64_t s) {
  const int32_t* rows[4];
  rows[0] = px;
  if (AFFINE) {
    rows[1] = signs[s] < 0 ? pyneg : py;
  } else {
    rows[1] = py;
    rows[2] = pzz;
    rows[3] = pzzz;
  }
#pragma unroll
  for (int c = 0; c < (AFFINE ? 2 : 4); c++) {
    const int4* p = reinterpret_cast<const int4*>(rows[c] + s * NL);
#pragma unroll
    for (int q = 0; q < 4; q++) r.v[4 * c + q] = p[q];
  }
}

__device__ __forceinline__ Fe raw_fe(const int4* v) {
  Fe a;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    a.w[2 * q] = (uint32_t)v[q].x | ((uint32_t)v[q].y << 16);
    a.w[2 * q + 1] = (uint32_t)v[q].z | ((uint32_t)v[q].w << 16);
  }
  return a;
}

template <bool AFFINE, bool FAST>
__global__ void __launch_bounds__(ACC_T)
accum_kernel(const int32_t* __restrict__ dig, int64_t dstride,
             const int64_t* __restrict__ src, const int32_t* __restrict__ signs,
             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
             const int32_t* __restrict__ p3, const int32_t* __restrict__ p4,
             int32_t* __restrict__ tx, int32_t* __restrict__ ty,
             int32_t* __restrict__ tzz, int32_t* __restrict__ tzzz, int nb,
             int32_t* __restrict__ cx, int32_t* __restrict__ cy,
             int32_t* __restrict__ czz, int32_t* __restrict__ czzz,
             int32_t* __restrict__ flag, int R, int C, FieldConsts fc) {
  __shared__ int32_t sh_d[ACC_T * ACC_PITCH];
  __shared__ int32_t sh_s[ACC_T * ACC_PITCH];
  // affine: p3 = yneg; XYZZ: p3 = zz, p4 = zzz
  const int32_t* pyneg = AFFINE ? p3 : nullptr;
  const int32_t* pzz = AFFINE ? nullptr : p3;
  const int32_t* pzzz = AFFINE ? nullptr : p4;
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * ACC_T;
  const int j = j0 + t;
  const int ncol = min(ACC_T, C - j0);
  const int H = min(ACC_ROWS, R);
  Pt acc;
  acc.x = fe_zero();
  acc.y = fe_zero();
  acc.zz = fe_zero();
  acc.zzz = fe_zero();
  int prev = -1;
  bool bad_any = false;
  for (int i0 = 0; i0 < R; i0 += H) {
    const int rows = min(H, R - i0);
    __syncthreads();  // the previous rows are consumed
    for (int e = t; e < ncol * H; e += ACC_T) {
      const int col = e / H, row = e - col * H;
      if (row < rows) {
        const int64_t p = (int64_t)(j0 + col) * R + i0 + row;
        sh_d[col * ACC_PITCH + row] = dig[p * dstride];
        sh_s[col * ACC_PITCH + row] = (int32_t)(src ? src[p] : p);
      }
    }
    __syncthreads();
    if (j >= C) continue;
    const int32_t* my_d = sh_d + t * ACC_PITCH;
    const int32_t* my_s = sh_s + t * ACC_PITCH;
    Raw<AFFINE> next;
    if (my_d[0] != 0)
      raw_load<AFFINE>(next, px, py, pyneg, pzz, pzzz, signs, my_s[0]);
    for (int i = 0; i < rows; i++) {
      const int d = my_d[i];
      const Raw<AFFINE> cur = next;
      if (i + 1 < rows && my_d[i + 1] != 0)
        raw_load<AFFINE>(next, px, py, pyneg, pzz, pzzz, signs, my_s[i + 1]);
      const bool boundary = d != prev;
      if (boundary && prev > 0 && prev <= nb)
        pt_store(tx, ty, tzz, tzzz, prev - 1, acc);
      prev = d;
      if (d == 0) {
        if (boundary) {
          acc.x = fe_zero();
          acc.y = fe_zero();
          acc.zz = fe_zero();
          acc.zzz = fe_zero();
        }
        continue;
      }
      Pt q;
      q.x = raw_fe(cur.v);
      q.y = raw_fe(cur.v + 4);
      if (AFFINE) {
        q.zz = fe_one(fc);
        q.zzz = q.zz;
      } else {
        q.zz = raw_fe(cur.v + 8);
        q.zzz = raw_fe(cur.v + 12);
      }
      if (boundary) {
        acc = q;
        continue;
      }
      Pt sum;
      if (FAST) {
        bool bad;
        if (AFFINE) {
          sum = xyzz_madd_fast(acc, q.x, q.y, true, bad, fc);
        } else {
          sum = xyzz_add_fast(acc, q, bad, fc);
        }
        bad_any |= bad;
      } else {
        sum = xyzz_add(acc, q, fc);
      }
      acc = sum;
    }
  }
  if (j >= C) return;
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

int nt_accum(int affine, int fast, const void* dig, int64_t dstride, const void* src,
             const void* signs, const void* px, const void* py, const void* p3,
             const void* p4, void* tx, void* ty, void* tzz, void* tzzz, int nb, void* cx,
             void* cy, void* czz, void* czzz, void* flag, int R, int C,
             const uint32_t* consts, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if (affine && (src == nullptr || signs == nullptr)) return (int)cudaErrorInvalidValue;
  const FieldConsts fc = load_consts(consts);
  const dim3 grid((C + ACC_T - 1) / ACC_T), block(ACC_T);
  cudaStream_t s = (cudaStream_t)stream;
#define NT_ACCUM_ARGS                                                                  \
  (const int32_t*)dig, dstride, (const int64_t*)src, (const int32_t*)signs,            \
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)p3, (const int32_t*)p4,  \
      (int32_t*)tx, (int32_t*)ty, (int32_t*)tzz, (int32_t*)tzzz, nb, (int32_t*)cx,     \
      (int32_t*)cy, (int32_t*)czz, (int32_t*)czzz, (int32_t*)flag, R, C, fc
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
