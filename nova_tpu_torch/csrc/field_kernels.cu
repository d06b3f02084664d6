// K1-K3: elementwise field and point kernels, one thread per element.
//
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace nt;

namespace {

// K1 replaces nova_tpu/fields/pallas_kernels.py::_mont_mul_2d (a*b*R^-1 mod p
// on 16-bit limbs). Bound on this card: bytes. A product is ~272 32-bit
// multiply-adds against 192 B moved (two 64 B operands in, 64 B out, in the
// 16-bit-limb layout), below the ~5 int32 operations per byte at which the
// H100 turns compute-bound. The design reads each operand once with 16 B
// vector loads, keeps the product in registers, and repacks limbs into
// 32-bit words so the arithmetic stays well under the memory time.
__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t n, FieldConsts fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_store(out + i * NL, fe_mul(fe_load(a + i * NL), fe_load(b + i * NL), fc));
}

// K2 replaces pallas_kernels.py::_xyzz_add_call (complete XYZZ add). Bound:
// near the balance point (14 products, ~3800 multiply-adds, against 768 B
// moved), so every intermediate stays in registers, each coordinate is read
// and written once, and only the selected branch of the masked formula is
// evaluated.
__global__ void __launch_bounds__(128)
xyzz_add_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                const int32_t* __restrict__ qzz, const int32_t* __restrict__ qzzz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int64_t n,
                FieldConsts fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt P = pt_load(px, py, pzz, pzzz, i);
  const Pt Q = pt_load(qx, qy, qzz, qzzz, i);
  pt_store(ox, oy, ozz, ozzz, i, xyzz_add(P, Q, fc));
}

// K3 replaces pallas_kernels.py::_xyzz_double_call (dbl-2008-s-1, a = 0).
// Bound: near the balance point (9 products against 512 B moved); one read
// and one write per coordinate, intermediates in registers.
__global__ void __launch_bounds__(128)
xyzz_double_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int64_t n,
                   FieldConsts fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pt_store(ox, oy, ozz, ozzz, i, xyzz_double(pt_load(px, py, pzz, pzzz, i), fc));
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* nt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int nt_mont_mul(const void* a, const void* b, void* out, int64_t n,
                const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  mont_mul_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, load_consts(consts));
  return (int)cudaGetLastError();
}

int nt_xyzz_add(const void* px, const void* py, const void* pzz, const void* pzzz,
                const void* qx, const void* qy, const void* qzz, const void* qzzz,
                void* ox, void* oy, void* ozz, void* ozzz, int64_t n,
                const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  xyzz_add_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
      (const int32_t*)pzzz, (const int32_t*)qx, (const int32_t*)qy,
      (const int32_t*)qzz, (const int32_t*)qzzz, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)ozz, (int32_t*)ozzz, n, load_consts(consts));
  return (int)cudaGetLastError();
}

int nt_xyzz_double(const void* px, const void* py, const void* pzz, const void* pzzz,
                   void* ox, void* oy, void* ozz, void* ozzz, int64_t n,
                   const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  xyzz_double_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz,
      (const int32_t*)pzzz, (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz,
      (int32_t*)ozzz, n, load_consts(consts));
  return (int)cudaGetLastError();
}

}  // extern "C"
