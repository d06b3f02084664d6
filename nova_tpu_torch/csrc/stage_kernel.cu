// B6: one combine stage of the int-scalar MSM, nova_tpu_torch/ops/msm2.py.
//
// Replaces nova_tpu/ops/msm2.py::_stage_call. A stage runs `rounds` (<= 4)
// Brent-Kung rounds over n lanes of XYZZ points: in round r, lane i absorbs
// lane i + 2^r where masks[r][i] is set; a partner at or past n is the
// identity (all coordinates zero). Modes:
//   complete  the complete add (26 products, with the doubling path);
//   fast      add without the doubling path (14 products), P = +-Q flagged;
//   fast0     fast, but round 0 uses the affine 6-product formula.
// With `live` given (affine input), only x/y are read and zz = zzz = the
// Montgomery one on live lanes and 0 elsewhere. The flag is the OR of `bad`
// over every active lane; it is written with atomicOr, so the caller zeroes
// it first.
//
// Design. Round r reads lane i + 2^r as it stands after round r - 1, so an
// in-place update without a barrier would race. Each block of STAGE_T
// threads loads a window of STAGE_T consecutive lanes, one per thread, and
// owns the first STAGE_OWN of them. The last STAGE_HALO lanes are a halo
// that the block recomputes: after `rounds` rounds an owned lane depends on
// at most 2^rounds - 1 <= 15 lanes after it, all inside the window, so an
// owned lane ends with the same value as in a global round-by-round run.
// Blocks step by STAGE_OWN lanes and write only the lanes they own (the
// TPU kernel's 256-lane overlap pad, at block scale). Partners are
// exchanged through shared memory between __syncthreads(), stored as 32
// words x STAGE_T lanes so that a warp's stores and loads fall in distinct
// banks.
//
// Bound: integer multiply-adds (up to 26 Montgomery products per active lane
// per round) against 128-256 B read and 256 B written per lane; the points
// stay in registers through all rounds. ptxas.log has registers and spills.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

constexpr int STAGE_T = 256;
constexpr int STAGE_HALO = 16;  // >= 2^4 - 1, the cone of 4 rounds
constexpr int STAGE_OWN = STAGE_T - STAGE_HALO;
constexpr int MAX_ROUNDS = 4;

enum { MODE_COMPLETE = 0, MODE_FAST = 1, MODE_FAST0 = 2 };

__device__ __forceinline__ void sh_store(uint32_t (*sh)[STAGE_T], int t, const Pt& P) {
#pragma unroll
  for (int k = 0; k < NW; k++) {
    sh[k][t] = P.x.w[k];
    sh[NW + k][t] = P.y.w[k];
    sh[2 * NW + k][t] = P.zz.w[k];
    sh[3 * NW + k][t] = P.zzz.w[k];
  }
}

__device__ __forceinline__ Pt sh_load(uint32_t (*sh)[STAGE_T], int t) {
  Pt P;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    P.x.w[k] = sh[k][t];
    P.y.w[k] = sh[NW + k][t];
    P.zz.w[k] = sh[2 * NW + k][t];
    P.zzz.w[k] = sh[3 * NW + k][t];
  }
  return P;
}

__device__ __forceinline__ Pt pt_zero() {
  Pt P;
  P.x = fe_zero();
  P.y = fe_zero();
  P.zz = fe_zero();
  P.zzz = fe_zero();
  return P;
}

template <int MODE, bool AFFINE_IN>
__global__ void __launch_bounds__(STAGE_T)
stage_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
             const int32_t* __restrict__ zz, const int32_t* __restrict__ zzz,
             const int32_t* __restrict__ live, const int32_t* __restrict__ masks,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
             int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz,
             int32_t* __restrict__ flag, int64_t n, int rounds, FieldConsts fc) {
  __shared__ uint32_t sh[4 * NW][STAGE_T];
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * STAGE_OWN + t;
  const bool in = i < n;
  Pt P = pt_zero();
  if (in) {
    P.x = fe_load(x + i * NL);
    P.y = fe_load(y + i * NL);
    if (AFFINE_IN) {
      P.zz = live[i] != 0 ? fe_one(fc) : fe_zero();
      P.zzz = P.zz;
    } else {
      P.zz = fe_load(zz + i * NL);
      P.zzz = fe_load(zzz + i * NL);
    }
  }
  bool bad_any = false;
  for (int r = 0; r < rounds; r++) {
    const int src = t + (1 << r);
    sh_store(sh, t, P);
    __syncthreads();
    // lanes past n were loaded as zeros; partners past the window only feed
    // halo lanes, whose values are never stored
    const Pt Q = src < STAGE_T ? sh_load(sh, src) : pt_zero();
    __syncthreads();
    if (!in || masks[(int64_t)r * n + i] == 0) continue;
    if (MODE == MODE_COMPLETE) {
      P = xyzz_add(P, Q, fc);
    } else {
      bool bad;
      if (MODE == MODE_FAST0 && r == 0) {
        P = xyzz_affine_add_fast(P, Q, bad, fc);
      } else {
        P = xyzz_add_fast(P, Q, bad, fc);
      }
      bad_any |= bad;
    }
  }
  if (in && t < STAGE_OWN) {
    pt_store(ox, oy, ozz, ozzz, i, P);
    if (bad_any) atomicOr(flag, 1);
  }
}

}  // namespace

extern "C" {

int nt_stage(int mode, int affine_in, const void* x, const void* y, const void* zz,
             const void* zzz, const void* live, const void* masks, void* ox, void* oy,
             void* ozz, void* ozzz, void* flag, int64_t n, int rounds,
             const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  if (rounds < 1 || rounds > MAX_ROUNDS || mode < MODE_COMPLETE || mode > MODE_FAST0)
    return (int)cudaErrorInvalidValue;
  const FieldConsts fc = load_consts(consts);
  const int64_t blocks = (n + STAGE_OWN - 1) / STAGE_OWN;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NT_STAGE_ARGS                                                                 \
  (const int32_t*)x, (const int32_t*)y, (const int32_t*)zz, (const int32_t*)zzz,      \
      (const int32_t*)live, (const int32_t*)masks, (int32_t*)ox, (int32_t*)oy,        \
      (int32_t*)ozz, (int32_t*)ozzz, (int32_t*)flag, n, rounds, fc
#define NT_STAGE_LAUNCH(M)                                                            \
  if (affine_in) {                                                                    \
    stage_kernel<M, true><<<(unsigned)blocks, STAGE_T, 0, s>>>(NT_STAGE_ARGS);        \
  } else {                                                                            \
    stage_kernel<M, false><<<(unsigned)blocks, STAGE_T, 0, s>>>(NT_STAGE_ARGS);       \
  }
  if (mode == MODE_COMPLETE) {
    NT_STAGE_LAUNCH(MODE_COMPLETE)
  } else if (mode == MODE_FAST) {
    NT_STAGE_LAUNCH(MODE_FAST)
  } else {
    NT_STAGE_LAUNCH(MODE_FAST0)
  }
#undef NT_STAGE_LAUNCH
#undef NT_STAGE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
