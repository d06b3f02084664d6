// P1, P2: the field microbenchmark's chained Montgomery products, one
// thread per column, one device function for both radices.
//
// P1 replaces perf/ubench_field.py::mont16_chain (body mont16_kernel), P2
// replaces perf/ubench_field.py::mont8_chain (body mont8_kernel). Both
// bodies compute one function: ITERS steps A <- T mod 2^256, with
// T = (A*B + M*p) / 2^256 and M = -A*B*p^-1 mod 2^256 over the Pallas base
// p, no final subtraction, the carry out of the top dropped. M is the one
// value below 2^256 that makes the sum divisible, whatever radix its
// digits are computed in, so the radix decides only the layout in memory:
// (NL, N) uint32 limb rows, NL = 16 limbs of 16 bits (P1) or 32 of 8 bits
// (P2). mont_chain_kernel<BITS> reads its column's NL limbs (neighbouring
// threads on neighbouring columns), packs A and B into 8 x 32-bit words
// (B once), runs the ITERS products in registers with field.cuh's
// fe_mul_lazy (fe_mul's carry-chain schedule, its subtract and top carry
// left out) and unpacks A once. The domain is limbs below 2^BITS, which is
// what the benchmark's inputs hold (perf/ubench_field.py::inputs) and
// where the packed words are the TPU bodies' value; the kernel does not
// check it.
//
// Bound on this card: operations. A product needs 264 multiply-adds on
// 32-bit words, against 3 x NL x 4 bytes moved once for the whole chain.
// The TPU bodies spent 528 (radix 2^16) and 2,080 (radix 2^8) 32-bit
// multiplies a product on the same function. On NVIDIA H100 80GB HBM3,
// 700.00 W (nova_tpu_torch/perf/bucket_stage.py, device time) 2^18 columns
// x 20 products take 0.107 ms (P1) and 0.121 ms (P2) against a 0.083 ms
// bound, where the radix bodies, carried over from the TPU, took 0.376-0.384
// and 0.668-0.673 ms; 40 registers.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <int BITS>
__global__ void __launch_bounds__(THREADS)
mont_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ o, int64_t n, int iters, nt::FieldConsts fc) {
  constexpr int LIMBS = 256 / BITS;     // limb rows of the layout
  constexpr int PER_WORD = 32 / BITS;   // limbs packed into one word
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  nt::Fe A = nt::fe_zero(), B = nt::fe_zero();
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    const int w = i / PER_WORD, s = BITS * (i % PER_WORD);
    A.w[w] |= a[i * n + col] << s;
    B.w[w] |= b[i * n + col] << s;
  }
  for (int it = 0; it < iters; ++it) A = nt::fe_mul_lazy(A, B, fc);
#pragma unroll
  for (int i = 0; i < LIMBS; ++i)
    o[i * n + col] = (A.w[i / PER_WORD] >> (BITS * (i % PER_WORD))) & MASK;
}

template <int BITS>
int launch_chain(const void* a, const void* b, void* out, int64_t n, int iters,
                 const uint32_t* consts, void* stream) {
  if (n <= 0) return 0;
  mont_chain_kernel<BITS><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, iters,
      nt::load_consts(consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the Pallas base field's 17 words (p, one, n0), fields/spec.py
int nt_mont16_chain(const void* a, const void* b, void* out, int64_t n, int iters,
                    const uint32_t* consts, void* stream) {
  return launch_chain<16>(a, b, out, n, iters, consts, stream);
}

int nt_mont8_chain(const void* a, const void* b, void* out, int64_t n, int iters,
                   const uint32_t* consts, void* stream) {
  return launch_chain<8>(a, b, out, n, iters, consts, stream);
}

}  // extern "C"
