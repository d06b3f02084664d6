// K4 (segmented bucket accumulation), K2s (the suffix pass of the bucket
// totals) and K5 (weighted bucket reduction) of the fixed-base MSM,
// nova_tpu_torch/ops/msm3.py and ops/msm2.py.
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

// -- K5 and the suffix pass: points kept whole (4 x 8 words) in scratch --------

// Shared memory, or global memory written by this block before a barrier.
__device__ __forceinline__ Pt pt_get(const Pt* p) { return *p; }

// Global memory written by other blocks: read through L2 (ld.global.cg), so
// no stale L1 line is seen.
__device__ __forceinline__ Pt pt_get_cg(const Pt* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Pt r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint4 v = __ldcg(q + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ Pt pt_identity_zero() {
  Pt Z;
  Z.x = fe_zero();
  Z.y = fe_zero();
  Z.zz = fe_zero();
  Z.zzz = fe_zero();
  return Z;
}

// One level of the bit-sum tree (see bucket_reduce_kernel). `src` holds
// `arrays` arrays of 2n points (array 0: the node sums R, array 1 + k: the
// partial bit-sums V_k); `dst` receives arrays + 1 arrays of n points: each
// array's pairs added (left + right) and, as the new last array, the right
// node sums R[2j + 1] (the level's own bit). Threads take items in turn.
template <bool CG>
__device__ __forceinline__ void tree_level(const Pt* src, Pt* dst, int arrays, int n,
                                           const FieldConsts& fc) {
  const int items = arrays * n;
  for (int q = threadIdx.x; q < items; q += blockDim.x) {
    const int a = q / n, j = q - a * n;
    const Pt* s = src + (int64_t)a * 2 * n + 2 * j;
    const Pt l = CG ? pt_get_cg(s) : pt_get(s);
    const Pt r = CG ? pt_get_cg(s + 1) : pt_get(s + 1);
    dst[(int64_t)a * n + j] = xyzz_add(l, r, fc);
    if (a == 0) dst[(int64_t)arrays * n + j] = r;
  }
}

// K5 replaces nova_tpu/ops/msm2.py::_bucket_reduce_call (:666 · :726) and
// its combine (the second call, the log2(m) doublings and the add of
// _bucket_reduce). It returns sum_i (i+1) T_i over an (nb, 16) XYZZ table,
// nb = 2^n, as
//   sum_i T_i + sum_k 2^k V_k,   V_k = sum of the T_i whose index has bit k,
// in one launch:
//   1. each block takes CH = 2*P consecutive buckets: thread j adds its pair
//      (R = T_2j + T_2j+1, V_0 = T_2j+1), then log2(P) levels of a binary
//      tree in shared memory, each adding pairs of node sums and of every
//      partial bit-sum, and keeping the right node sums as the next bit's
//      partials (tree_level). The block writes R and V_0..V_{c-1}
//      (c = log2 CH) to scratch.
//   2. the last block to finish (an atomic counter elects it) continues the
//      same tree over the B = nb / CH block results in scratch, the high
//      bits coming from the block index.
//   3. it doubles V_k k times (thread k) and adds the n + 1 values
//      [sum T, 2^0 V_0, .., 2^(n-1) V_(n-1)] in a pairwise tree of 32 slots.
// Every add is complete (empty buckets, equal partial sums and P + -P
// occur). The order of adds is fixed by nb alone (one global pairwise tree,
// whatever P is), and msm2.bucket_reduce_plain repeats it.
//
// Bound on this card: not the 2(nb - 1) adds (~0.015 ms of multiply-adds
// at nb = 2^15) but their depth. Any reduction of nb points is at least
// log2(nb) adds deep, and a chained complete add takes ~12.7 us on a warp
// that runs alone (perf/bucket_stage.py).
// The tree keeps that depth (n levels, one add each, the partial bit-sums
// added by other threads beside the node sums), does ~2 nb adds in all, and
// leaves up to n - 1 doublings and 5 adds for the end. The TPU kernel and
// the port's first K5 ran two Hillis-Steele suffix passes per group of 256
// buckets (16 rounds of adds on every lane), a second launch and nine
// single-row launches for the combine.
__global__ void __launch_bounds__(256, 1)
bucket_reduce_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                     const int32_t* __restrict__ tzz, const int32_t* __restrict__ tzzz,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz,
                     Pt* __restrict__ scratch, unsigned int* __restrict__ counter, int n,
                     int logp, FieldConsts fc) {
  extern __shared__ Pt sh[];
  __shared__ bool last;
  const int P = 1 << logp;        // pair threads of a block
  const int c = logp + 1;         // bits inside a block's CH = 2P buckets
  const int B = 1 << (n - c);     // blocks
  const int tid = threadIdx.x;
  Pt* buf[2] = {sh, sh + 2 * P};  // ping-pong, 2P points each
  // 1. the pairs and log2(P) levels in shared memory
  if (tid < P) {
    const int64_t i = ((int64_t)blockIdx.x * P + tid) * 2;
    const Pt l = pt_load(tx, ty, tzz, tzzz, i);
    const Pt r = pt_load(tx, ty, tzz, tzzz, i + 1);
    buf[0][tid] = xyzz_add(l, r, fc);
    buf[0][P + tid] = r;
  }
  __syncthreads();
  int arrays = 2;
  for (int lv = 1; lv <= logp; lv++) {
    tree_level<false>(buf[(lv - 1) & 1], buf[lv & 1], arrays, P >> lv, fc);
    arrays++;
    __syncthreads();
  }
  // R, V_0..V_{c-1} of this block: arrays = 1 + c points of buf[logp & 1]
  Pt* leaves = scratch;                       // (1 + c) arrays of B points
  Pt* pong[2] = {scratch, scratch + (int64_t)(1 + c) * B};
  for (int a = tid; a < arrays; a += blockDim.x)
    leaves[(int64_t)a * B + blockIdx.x] = buf[logp & 1][a];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)(B - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 2. the tree over the blocks, in scratch
  for (int lv = 1; (B >> lv) >= 1; lv++) {
    tree_level<true>(pong[(lv - 1) & 1], pong[lv & 1], arrays, B >> lv, fc);
    arrays++;
    __threadfence_block();
    __syncthreads();
  }
  const Pt* top = pong[(n - c) & 1];  // R, V_0..V_{n-1}: one point each
  // 3. 2^k V_k, then the pairwise sum of 32 slots [R, 2^0 V_0, ..]
  Pt* slot[2] = {sh, sh + 32};
  for (int k = tid; k < 32; k += blockDim.x) {
    Pt v = pt_identity_zero();
    if (k == 0) {
      v = pt_get_cg(top);
    } else if (k <= n) {
      v = pt_get_cg(top + k);
      for (int d = 1; d < k; d++) v = xyzz_double(v, fc);
    }
    slot[0][k] = v;
  }
  __syncthreads();
  int w = 32, cur = 0;
  for (; w > 1; w >>= 1, cur ^= 1) {
    for (int j = tid; j < w / 2; j += blockDim.x)
      slot[cur ^ 1][j] = xyzz_add(slot[cur][2 * j], slot[cur][2 * j + 1], fc);
    __syncthreads();
  }
  if (tid == 0) pt_store(ox, oy, ozz, ozzz, 0, slot[cur][0]);
}

// K2s replaces the suffix pass of msm3._bucket_totals over the column-end
// carries: nova_tpu/ops/msm3.py::_suffix_segmented (:475, 12 rounds of K2 at
// 4,096 carries and ~16 PyTorch ops a round), then the run heads picked by
// searchsorted and a gather. Input: m digits (each positive digit in one
// contiguous run; 0 and -1 are inert) and their XYZZ points; output: each
// run's total at row d - 1 of a zeroed (nb, 16) table, the convention of
// K4's tail table. One block of SUF_T threads; thread s owns the slice
// [s*E, s*E + E):
//   1. each thread walks its slice backwards, acc = v[p] + acc while the
//      digit repeats, writes the runs that lie inside the slice, and keeps
//      its first run's partial (HC) and last run's (TC); the interior
//      carries of a slice with no repeated digit are copied out without the
//      walk, by the whole block, consecutive threads on consecutive rows;
//   2. runs that span slices: a segmented Hillis-Steele suffix scan of HC
//      over the slices in shared memory, where slice s links to s + 1 when
//      it holds a single run that the next slice continues;
//   3. the slice where a spanning run starts writes TC + the scan of the
//      next slice (a single-run slice writes its scan value).
// Bound: the adds the data needs (m minus the number of runs), none on the
// main path (the commit's 4,096 level-2 carries have distinct digits), so
// the bytes: the carries read once and the run totals written. One SM
// moves them (each slice's first and last carries from rows E apart), which
// keeps the kernel far above that bound: 0.089-0.090 ms on the commit's
// 4,096 carries against 0.101-0.102 ms when each thread copied its own
// slice's interior (nova_tpu_torch/perf/bucket_stage.py, NVIDIA H100 80GB
// HBM3, 700.00 W). The adds that do occur are at most E - 1 + log2(S) + 1 deep.
// The order of adds is msm3.suffix_to_buckets_plain's.
constexpr int SUF_T = 256;

__device__ __forceinline__ void put_run(int d, int nb, const Pt& P, int32_t* tx,
                                        int32_t* ty, int32_t* tzz, int32_t* tzzz) {
  if (d >= 1 && d <= nb) pt_store(tx, ty, tzz, tzzz, d - 1, P);
}

__global__ void __launch_bounds__(SUF_T, 1)
suffix_buckets_kernel(const int32_t* __restrict__ dig, const int32_t* __restrict__ vx,
                      const int32_t* __restrict__ vy, const int32_t* __restrict__ vzz,
                      const int32_t* __restrict__ vzzz, int m, int E,
                      int32_t* __restrict__ tx, int32_t* __restrict__ ty,
                      int32_t* __restrict__ tzz, int32_t* __restrict__ tzzz, int nb,
                      FieldConsts fc) {
  __shared__ Pt val[SUF_T];  // 32 KB
  __shared__ unsigned char fl[SUF_T], copies[SUF_T];
  const int S = m / E;
  const int s = threadIdx.x;
  bool multi = false, link = false, starts = false;
  int hd = 0, td = 0;
  Pt TC = pt_identity_zero();
  if (s < S) {
    const int a = s * E, e = a + E;
    bool repeat = false;
    for (int p = a; p + 1 < e; p++) repeat |= dig[p] == dig[p + 1];
    Pt acc;
    int drun;
    if (!repeat) {
      // one carry per run inside the slice (the main path's case): the
      // whole block copies the interior runs out after step 1, and only
      // the first and last runs can continue into a neighbour
      if (E > 1) {
        TC = pt_load(vx, vy, vzz, vzzz, e - 1);
        td = dig[e - 1];
        multi = true;
      }
      acc = pt_load(vx, vy, vzz, vzzz, a);
      drun = dig[a];
    } else {
      acc = pt_load(vx, vy, vzz, vzzz, e - 1);
      drun = dig[e - 1];
      for (int p = e - 2; p >= a; p--) {
        const int d = dig[p];
        const Pt v = pt_load(vx, vy, vzz, vzzz, p);
        if (d == drun) {
          acc = xyzz_add(v, acc, fc);
          continue;
        }
        if (!multi) {
          TC = acc;
          td = drun;
          multi = true;
        } else {
          put_run(drun, nb, acc, tx, ty, tzz, tzzz);
        }
        acc = v;
        drun = d;
      }
    }
    hd = drun;
    if (!multi) {
      TC = acc;
      td = hd;
    }
    starts = s == 0 || dig[a - 1] != hd;
    link = e < m && dig[e] == td;
    if (multi && starts) put_run(hd, nb, acc, tx, ty, tzz, tzzz);
    val[s] = acc;
    fl[s] = (multi || !link) ? 1 : 0;
    copies[s] = !repeat;
  }
  __syncthreads();
  // the interior carries of repeat-free slices, copied as raw rows by
  // consecutive threads from consecutive rows
  for (int p = s; p < m; p += SUF_T) {
    const int o = p % E, d = dig[p];
    if (copies[p / E] && o > 0 && o + 1 < E && d >= 1 && d <= nb)
      pt_copy(tx, ty, tzz, tzzz, d - 1, vx, vy, vzz, vzzz, p);
  }
  // 2. in place: each round reads its partner before the barrier, writes after
  for (int off = 1; off < S; off <<= 1) {
    const bool has = s + off < S;
    Pt v, w;
    unsigned char f = 1, g = 1;
    if (s < S) {
      v = val[s];
      f = fl[s];
      if (has && !f) w = val[s + off];
      if (has) g = fl[s + off];
    }
    __syncthreads();
    if (s < S && has) {
      if (!f) val[s] = xyzz_add(v, w, fc);
      fl[s] = f | g;
    }
    __syncthreads();
  }
  // 3. the runs that start in this slice and reach its end
  if (s >= S) return;
  if (!multi) {
    if (starts) put_run(hd, nb, val[s], tx, ty, tzz, tzzz);
  } else {
    put_run(td, nb, link ? xyzz_add(TC, val[s + 1], fc) : TC, tx, ty, tzz,
            tzzz);
  }
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

// scratch: 2 * (logp + 2) * (nb / (2 << logp)) points (Pt, 128 B each);
// counter: one zeroed unsigned int.
int nt_bucket_reduce(const void* tx, const void* ty, const void* tzz, const void* tzzz,
                     void* ox, void* oy, void* ozz, void* ozzz, void* scratch,
                     void* counter, int n, int logp, const uint32_t* consts,
                     void* stream) {
  if (n < 1 || n > 24 || logp < 0 || logp > 8 || logp + 1 > n)
    return (int)cudaErrorInvalidValue;
  const int P = 1 << logp;
  const int threads = P < 32 ? 32 : P;
  const size_t smem = sizeof(Pt) * (size_t)(4 * P < 64 ? 64 : 4 * P);
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(bucket_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(sizeof(Pt) * 4 * 256));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  bucket_reduce_kernel<<<1u << (n - logp - 1), threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tzz, (const int32_t*)tzzz,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, (Pt*)scratch,
      (unsigned int*)counter, n, logp, load_consts(consts));
  return (int)cudaGetLastError();
}

int nt_suffix_buckets(const void* dig, const void* vx, const void* vy, const void* vzz,
                      const void* vzzz, int m, int E, void* tx, void* ty, void* tzz,
                      void* tzzz, int nb, const uint32_t* consts, void* stream) {
  if (m <= 0) return 0;
  if (E <= 0 || m % E != 0 || m / E > SUF_T) return (int)cudaErrorInvalidValue;
  suffix_buckets_kernel<<<1, SUF_T, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dig, (const int32_t*)vx, (const int32_t*)vy, (const int32_t*)vzz,
      (const int32_t*)vzzz, m, E, (int32_t*)tx, (int32_t*)ty, (int32_t*)tzz,
      (int32_t*)tzzz, nb, load_consts(consts));
  return (int)cudaGetLastError();
}

}  // extern "C"
