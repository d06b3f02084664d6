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
// Bound: integer multiply-adds. In the first stage of a commit about half
// the lanes are active in round 0, a quarter in round 1, an eighth and a
// sixteenth after that: ~9 products per lane against 128-256 B read and
// 256 B written.
//
// Design. A block of STAGE_T threads holds a window of STAGE_W consecutive
// lanes in shared memory (128 B a lane as 32-bit words, ~69 KB, three blocks
// an SM) and owns the first STAGE_OWN of them; the last STAGE_HALO lanes are
// a halo that the block recomputes: after `rounds` rounds an owned lane
// depends on at most 2^rounds - 1 <= 15 lanes after it, all in the window,
// so it ends with the value of a global round-by-round run. Blocks step by
// STAGE_OWN lanes and write only the lanes they own.
//
// Each round first compacts the window's active lanes into a list (a warp
// ballot and a prefix count over masks[r], in lane order), then hands the
// list out STAGE_T at a time: thread t adds list entry c0 + t. So a warp
// issues one add per needed add, instead of every lane walking every round
// as a one-thread-per-lane kernel must (~5x the products in fast0). Lanes
// whose partner lies past the window are halo lanes that no owned lane
// reads, and are skipped.
//
// Reads stay ahead of writes for any masks: within a chunk every thread
// reads its P_i and P_{i+2^r}, a barrier, then writes P_i. The list is in
// lane order, so a lane j read as a partner by an active lane i < j is read
// in i's chunk, no later than j's own chunk, whose writes follow that
// chunk's barrier.
//
// Word k of window lane L lives at row k, column L + L/32: the skew keeps
// the active lanes of a round (spaced 2, 4, 8 or 16 lanes apart) in
// distinct banks, and the row pitch (532, 4 mod 16) keeps the coalesced
// loads and stores of the window in distinct banks as well.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

constexpr int STAGE_T = 128;
constexpr int STAGE_W = 512;
constexpr int STAGE_HALO = 16;  // >= 2^4 - 1, the cone of 4 rounds
constexpr int STAGE_OWN = STAGE_W - STAGE_HALO;
constexpr int STAGE_PITCH = 532;  // >= STAGE_W + STAGE_W / 32, 4 mod 16
constexpr int STAGE_WARPS = STAGE_T / 32;
constexpr int MAX_ROUNDS = 4;
constexpr int PT_WORDS = 4 * NW;
constexpr size_t STAGE_SMEM =
    sizeof(uint32_t) * PT_WORDS * STAGE_PITCH + sizeof(uint16_t) * STAGE_W +
    sizeof(int) * STAGE_WARPS;

static_assert(STAGE_PITCH >= STAGE_W + STAGE_W / 32, "skewed lanes must fit a row");
static_assert(STAGE_W % STAGE_T == 0, "the compaction walks the window in whole blocks");

enum { MODE_COMPLETE = 0, MODE_FAST = 1, MODE_FAST0 = 2 };

__device__ __forceinline__ int slot(int lane) { return lane + (lane >> 5); }

__device__ __forceinline__ Fe sh_fe(const uint32_t* sh, int row, int col) {
  Fe a;
#pragma unroll
  for (int k = 0; k < NW; k++) a.w[k] = sh[(row + k) * STAGE_PITCH + col];
  return a;
}

__device__ __forceinline__ void sh_put(uint32_t* sh, int row, int col, const Fe& a) {
#pragma unroll
  for (int k = 0; k < NW; k++) sh[(row + k) * STAGE_PITCH + col] = a.w[k];
}

__device__ __forceinline__ Pt sh_load(const uint32_t* sh, int lane) {
  const int col = slot(lane);
  Pt P;
  P.x = sh_fe(sh, 0, col);
  P.y = sh_fe(sh, NW, col);
  P.zz = sh_fe(sh, 2 * NW, col);
  P.zzz = sh_fe(sh, 3 * NW, col);
  return P;
}

__device__ __forceinline__ void sh_store(uint32_t* sh, int lane, const Pt& P) {
  const int col = slot(lane);
  sh_put(sh, 0, col, P.x);
  sh_put(sh, NW, col, P.y);
  sh_put(sh, 2 * NW, col, P.zz);
  sh_put(sh, 3 * NW, col, P.zzz);
}

// Coordinate `row0` of the window from (n, 16) int32 limb rows: one int4
// (4 limbs, 2 words) per thread and step, so a warp reads 512 contiguous B.
__device__ __forceinline__ void window_load(uint32_t* sh, int row0,
                                            const int32_t* __restrict__ src,
                                            int64_t base, int nwin) {
  for (int f = threadIdx.x; f < STAGE_W * 4; f += STAGE_T) {
    const int lane = f >> 2, q = f & 3;
    int4 v = make_int4(0, 0, 0, 0);
    if (lane < nwin) v = reinterpret_cast<const int4*>(src + (base + lane) * NL)[q];
    sh[(row0 + 2 * q) * STAGE_PITCH + slot(lane)] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    sh[(row0 + 2 * q + 1) * STAGE_PITCH + slot(lane)] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

__device__ __forceinline__ void window_store(const uint32_t* sh, int row0,
                                             int32_t* __restrict__ dst, int64_t base,
                                             int nown) {
  for (int f = threadIdx.x; f < nown * 4; f += STAGE_T) {
    const int lane = f >> 2, q = f & 3;
    const uint32_t a = sh[(row0 + 2 * q) * STAGE_PITCH + slot(lane)];
    const uint32_t b = sh[(row0 + 2 * q + 1) * STAGE_PITCH + slot(lane)];
    reinterpret_cast<int4*>(dst + (base + lane) * NL)[q] =
        make_int4((int32_t)(a & 0xFFFFu), (int32_t)(a >> 16), (int32_t)(b & 0xFFFFu),
                  (int32_t)(b >> 16));
  }
}

template <int MODE, bool AFFINE_IN>
__global__ void __launch_bounds__(STAGE_T, 3)
stage_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
             const int32_t* __restrict__ zz, const int32_t* __restrict__ zzz,
             const int32_t* __restrict__ live, const int32_t* __restrict__ masks,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
             int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz,
             int32_t* __restrict__ flag, int64_t n, int rounds, FieldConsts fc) {
  extern __shared__ __align__(16) uint32_t sh[];
  uint16_t* list = reinterpret_cast<uint16_t*>(sh + PT_WORDS * STAGE_PITCH);
  int* warp_count = reinterpret_cast<int*>(list + STAGE_W);
  const int t = threadIdx.x;
  const int warp = t >> 5, wl = t & 31;
  const int64_t base = (int64_t)blockIdx.x * STAGE_OWN;
  const int nwin = (int)min((int64_t)STAGE_W, n - base);

  window_load(sh, 0, x, base, nwin);
  window_load(sh, NW, y, base, nwin);
  if (AFFINE_IN) {
    for (int lane = t; lane < STAGE_W; lane += STAGE_T) {
      const bool on = lane < nwin && live[base + lane] != 0;
#pragma unroll
      for (int k = 0; k < NW; k++) {
        const uint32_t w = on ? fc.one[k] : 0u;
        sh[(2 * NW + k) * STAGE_PITCH + slot(lane)] = w;
        sh[(3 * NW + k) * STAGE_PITCH + slot(lane)] = w;
      }
    }
  } else {
    window_load(sh, 2 * NW, zz, base, nwin);
    window_load(sh, 3 * NW, zzz, base, nwin);
  }

  bool bad_any = false;
  for (int r = 0; r < rounds; r++) {
    const int s = 1 << r;
    const int32_t* mrow = masks + (int64_t)r * n + base;
    int count = 0;
    for (int g = 0; g < STAGE_W; g += STAGE_T) {
      const int lane = g + t;
      const bool act = lane + s < STAGE_W && lane < nwin && mrow[lane] != 0;
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, act);
      if (wl == 0) warp_count[warp] = __popc(bal);
      __syncthreads();
      int before = count;
#pragma unroll
      for (int w = 0; w < STAGE_WARPS; w++) {
        const int c = warp_count[w];
        if (w < warp) before += c;
        count += c;
      }
      if (act) list[before + __popc(bal & ((1u << wl) - 1u))] = (uint16_t)lane;
      __syncthreads();
    }
    for (int c0 = 0; c0 < count; c0 += STAGE_T) {
      const int item = c0 + t;
      int lane = 0;
      Pt R;
      if (item < count) {
        lane = list[item];
        const Pt P = sh_load(sh, lane);
        const Pt Q = sh_load(sh, lane + s);
        if (MODE == MODE_COMPLETE) {
          // xyzz_add, with the identity cases read back from the window
          // after the formula instead of kept in registers through it
          const bool pz = fe_is_zero(P.zz), qz = fe_is_zero(Q.zz);
          R = xyzz_add_live(P, Q, fc);
          if (pz) R = sh_load(sh, lane + s);
          else if (qz) R = sh_load(sh, lane);
        } else {
          bool bad;
          if (MODE == MODE_FAST0 && r == 0) {
            R = xyzz_affine_add_fast(P, Q, bad, fc);
          } else {
            R = xyzz_add_fast(P, Q, bad, fc);
          }
          // the flag follows the lane's ownership, not the thread
          bad_any |= bad && lane < STAGE_OWN;
        }
      }
      __syncthreads();
      if (item < count) sh_store(sh, lane, R);
    }
    __syncthreads();
  }

  const int nown = (int)min((int64_t)STAGE_OWN, n - base);
  window_store(sh, 0, ox, base, nown);
  window_store(sh, NW, oy, base, nown);
  window_store(sh, 2 * NW, ozz, base, nown);
  window_store(sh, 3 * NW, ozzz, base, nown);
  if (__syncthreads_or(bad_any) && t == 0) atomicOr(flag, 1);
}

template <int MODE, bool AFFINE_IN>
cudaError_t launch_stage(unsigned blocks, cudaStream_t s, const int32_t* x,
                         const int32_t* y, const int32_t* zz, const int32_t* zzz,
                         const int32_t* live, const int32_t* masks, int32_t* ox,
                         int32_t* oy, int32_t* ozz, int32_t* ozzz, int32_t* flag,
                         int64_t n, int rounds, const FieldConsts& fc) {
  const cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<MODE, AFFINE_IN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STAGE_SMEM);
  if (err != cudaSuccess) return err;
  stage_kernel<MODE, AFFINE_IN><<<blocks, STAGE_T, STAGE_SMEM, s>>>(
      x, y, zz, zzz, live, masks, ox, oy, ozz, ozzz, flag, n, rounds, fc);
  return cudaGetLastError();
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
  (unsigned)blocks, s, (const int32_t*)x, (const int32_t*)y, (const int32_t*)zz,      \
      (const int32_t*)zzz, (const int32_t*)live, (const int32_t*)masks, (int32_t*)ox, \
      (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, (int32_t*)flag, n, rounds, fc
#define NT_STAGE_LAUNCH(M)                                                   \
  return (int)(affine_in ? launch_stage<M, true>(NT_STAGE_ARGS)              \
                         : launch_stage<M, false>(NT_STAGE_ARGS));
  if (mode == MODE_COMPLETE) NT_STAGE_LAUNCH(MODE_COMPLETE)
  if (mode == MODE_FAST) NT_STAGE_LAUNCH(MODE_FAST)
  NT_STAGE_LAUNCH(MODE_FAST0)
#undef NT_STAGE_LAUNCH
#undef NT_STAGE_ARGS
}

}  // extern "C"
