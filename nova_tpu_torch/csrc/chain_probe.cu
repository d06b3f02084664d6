// The latency probe of nova_tpu_torch/perf/bucket_stage.py (no TPU
// counterpart, on no path of the program): each thread chains n complete
// adds acc <- acc + Q (mode 0, field.cuh's xyzz_add), n doublings (mode 1)
// or n Montgomery products acc <- acc * b (mode 2, field.cuh's fe_mul) on
// its own row, so one warp alone times one step's latency and a full card
// the throughput. It uses nothing of field.cuh but fe_mul, xyzz_add,
// xyzz_double and the row loads, so it also builds against an older
// field.cuh, which is how bucket_stage.py times two versions of the
// product. Not counted in _build.LAUNCHES.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

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
