// 256-bit Montgomery field arithmetic and XYZZ point formulas shared by
// every kernel of the port (field_kernels.cu: K1-K3, msm_kernels.cu: K4,
// K5 and K2s, stage_kernel.cu: B6, ubench_kernels.cu: P1/P2 and the latency
// probe).
//
// Public layout (the JAX package's): an element is 16 int32 lanes, each a
// 16-bit limb, little-endian, in Montgomery form with R = 2^256. Inside a
// thread the limbs are repacked into 8 x 32-bit words. With R = 2^256 the
// Montgomery values are the same; only n0 changes, to -p^-1 mod 2^32.
// Every routine computes exactly what the 16-bit formulas of
// nova_tpu/ops/msm2.py::_limb_ops compute: a Montgomery product is
// T = (a*b + m*p) / 2^256 with the unique m < 2^256 that makes the sum
// divisible, followed by one subtract of p when T >= p or T >= 2^256, so
// the outputs are bit-identical whatever the word size.
//
// The field constants arrive as a struct argument, so one build serves
// every field.
#pragma once

#include <cstdint>

namespace nt {

constexpr int NW = 8;   // 32-bit words per element in registers
constexpr int NL = 16;  // 16-bit limbs per element in memory

struct FieldConsts {
  uint32_t p[NW];
  uint32_t one[NW];  // Montgomery one, 2^256 mod p
  uint32_t n0;       // -p^-1 mod 2^32
};

struct Fe {
  uint32_t w[NW];
};

struct Pt {
  Fe x, y, zz, zzz;
};

// -- memory <-> registers ---------------------------------------------------

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int4 v = s[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ dst, const Fe& a) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int4 v;
    v.x = (int32_t)(a.w[2 * q] & 0xFFFFu);
    v.y = (int32_t)(a.w[2 * q] >> 16);
    v.z = (int32_t)(a.w[2 * q + 1] & 0xFFFFu);
    v.w = (int32_t)(a.w[2 * q + 1] >> 16);
    d[q] = v;
  }
}

__device__ __forceinline__ Pt pt_load(const int32_t* x, const int32_t* y,
                                      const int32_t* zz, const int32_t* zzz,
                                      int64_t i) {
  Pt P;
  P.x = fe_load(x + i * NL);
  P.y = fe_load(y + i * NL);
  P.zz = fe_load(zz + i * NL);
  P.zzz = fe_load(zzz + i * NL);
  return P;
}

__device__ __forceinline__ void pt_store(int32_t* x, int32_t* y, int32_t* zz,
                                         int32_t* zzz, int64_t i, const Pt& P) {
  fe_store(x + i * NL, P.x);
  fe_store(y + i * NL, P.y);
  fe_store(zz + i * NL, P.zz);
  fe_store(zzz + i * NL, P.zzz);
}

// -- field ops ----------------------------------------------------------------

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; k++) r.w[k] = 0u;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldConsts& fc) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; k++) r.w[k] = fc.one[k];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) acc |= a.w[k];
  return acc == 0u;
}

// -- PTX carry chains -----------------------------------------------------------
//
// One instruction each, in `asm volatile` so that the order of the carry
// flag's producers and consumers is kept: a chain is a run of these calls
// with nothing between them that touches the flag (plain C arithmetic never
// does). Each maps to one or two SASS integer instructions whose carry lives
// in a predicate register.
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
// lo(a*b) + c and hi(a*b) + c, with and without the carry in
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

// t - p when t >= p or `overflow` is set, else t (one conditional subtract,
// modulo 2^256).
__device__ __forceinline__ Fe fe_cond_sub(const uint32_t t[NW], uint32_t overflow,
                                          const FieldConsts& fc) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(t[0], fc.p[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) d[k] = ptx::subc_cc(t[k], fc.p[k]);
  const uint32_t borrow = ptx::subc(0u, 0u);  // 0, or all ones on a borrow
  const bool need = (borrow == 0u) || (overflow != 0u);
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; k++) r.w[k] = need ? d[k] : t[k];
  return r;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t t[NW];
  t[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) t[k] = ptx::addc_cc(a.w[k], b.w[k]);
  return fe_cond_sub(t, ptx::addc(0u, 0u), fc);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const FieldConsts& fc) {
  return fe_add(a, a, fc);
}

// a - b, plus p (modulo 2^256) when the subtraction borrows.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < NW; k++) d[k] = ptx::subc_cc(a.w[k], b.w[k]);
  const uint32_t mask = ptx::subc(0u, 0u);
  Fe r;
  r.w[0] = ptx::add_cc(d[0], fc.p[0] & mask);
#pragma unroll
  for (int k = 1; k < NW; k++) r.w[k] = ptx::addc_cc(d[k], fc.p[k] & mask);
  return r;
}

// -- the Montgomery product ---------------------------------------------------
//
// a*b*2^-256 mod p by the contract above, word-serial in b (8 rows, each
// a*b_i then m_i*p with m_i = t_0 * n0) like CIOS, but with the partial
// products split by the parity of their word of a (or p) into two
// accumulators, `ev` (words at positions 0..7) and `od` (positions 1..8),
// after the even/odd scheme of Emmart, Luitjens, Weems and Woolley
// ("Optimizing Modular Multiplication for NVIDIA's Maxwell GPUs", ARITH
// 2016) and sppark's mont_t: each row is two chains of 8 carry-propagating
// multiply-adds (lo, hi, lo, hi, ...) instead of one chain of 16, and the
// two interleave. The shift by one word after a row is a renaming: the odd
// accumulator becomes the even one, the even one moves down two words into
// the odd one while the next row's odd products are added. `x` (position 9)
// takes every carry out of the top, because a, b < 2^256 are not assumed
// canonical: a row's sum t + a*b_i + m_i*p stays below 2^32 (2^256 + p) but
// may pass 2^288 in any field (for secp, whose p is within 2^33 of 2^256,
// even with canonical inputs), so no field may drop that carry. The Python model in tests/test_torch_field_product.py
// repeats this schedule op for op.
//
// On NVIDIA H100 80GB HBM3, 700.00 W (nova_tpu_torch/perf/bucket_stage.py,
// probe mode 2): a chained product takes 0.51-0.61 us on a warp that runs
// alone and the card completes 39,900-43,700 products/us, against
// 0.71-0.81 us and 27,000-29,800/us for CIOS on uint64_t (~128 dependent
// wide multiply-adds); the probe's loop compiles to 520 SASS instructions
// against 856. A chain is still serial in the one carry flag, so a lone
// warp's product is latency-bound on its ~32 carry steps a row; the card's
// rate is bound by issue. Bound of the product itself: 264 multiply-adds.

// Row 0: ev = a_even * b0, od = a_odd * b0 (no overlap, no carries).
__device__ __forceinline__ void mul_row0(uint32_t ev[NW], uint32_t od[NW], const Fe& a,
                                         uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    ev[j] = a.w[j] * bi;
    ev[j + 1] = __umulhi(a.w[j], bi);
    od[j] = a.w[j + 1] * bi;
    od[j + 1] = __umulhi(a.w[j + 1], bi);
  }
}

// Rows 1..7: `e` holds the previous odd accumulator and becomes the even
// one; `o` holds the previous even one (its word 0 is zero after the
// reduction) and becomes the odd one, two words down, with the carry word
// x of position 9 entering at its top.
__device__ __forceinline__ void mul_row(uint32_t e[NW], uint32_t o[NW], uint32_t& x,
                                        const Fe& a, uint32_t bi) {
  e[0] = ptx::add_cc(e[0], o[1]);
#pragma unroll
  for (int j = 0; j < NW - 2; j += 2) {
    o[j] = ptx::madc_lo_cc(a.w[j + 1], bi, o[j + 2]);
    o[j + 1] = ptx::madc_hi_cc(a.w[j + 1], bi, o[j + 3]);
  }
  o[NW - 2] = ptx::madc_lo_cc(a.w[NW - 1], bi, 0u);
  o[NW - 1] = ptx::madc_hi_cc(a.w[NW - 1], bi, x);
  x = ptx::addc(0u, 0u);
  e[0] = ptx::mad_lo_cc(a.w[0], bi, e[0]);
  e[1] = ptx::madc_hi_cc(a.w[0], bi, e[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    e[j] = ptx::madc_lo_cc(a.w[j], bi, e[j]);
    e[j + 1] = ptx::madc_hi_cc(a.w[j], bi, e[j + 1]);
  }
  o[NW - 1] = ptx::addc_cc(o[NW - 1], 0u);
  x = ptx::addc(x, 0u);
}

// The row's reduction: m = ev[0] * n0, ev += p_even * m (ev[0] becomes 0),
// od += p_odd * m; carries out of the top go to x.
__device__ __forceinline__ void redc_row(uint32_t ev[NW], uint32_t od[NW], uint32_t& x,
                                         const FieldConsts& fc) {
  const uint32_t m = ev[0] * fc.n0;
  od[0] = ptx::mad_lo_cc(fc.p[1], m, od[0]);
  od[1] = ptx::madc_hi_cc(fc.p[1], m, od[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    od[j] = ptx::madc_lo_cc(fc.p[j + 1], m, od[j]);
    od[j + 1] = ptx::madc_hi_cc(fc.p[j + 1], m, od[j + 1]);
  }
  x = ptx::addc(x, 0u);
  ev[0] = ptx::mad_lo_cc(fc.p[0], m, ev[0]);
  ev[1] = ptx::madc_hi_cc(fc.p[0], m, ev[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    ev[j] = ptx::madc_lo_cc(fc.p[j], m, ev[j]);
    ev[j + 1] = ptx::madc_hi_cc(fc.p[j], m, ev[j + 1]);
  }
  od[NW - 1] = ptx::addc_cc(od[NW - 1], 0u);
  x = ptx::addc(x, 0u);
}

// LAZY: the product's lazy ending, T mod 2^256 with no subtract and the
// carry word dropped (the field microbenchmark's chains, P1/P2); fe_mul and
// fe_mul_lazy below.
template <bool LAZY>
__device__ __forceinline__ Fe fe_mul_t(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t u[NW], v[NW], x = 0u;
  mul_row0(u, v, a, b.w[0]);
  redc_row(u, v, x, fc);
#pragma unroll
  for (int i = 1; i < NW; i += 2) {  // the accumulators swap roles each row
    mul_row(v, u, x, a, b.w[i]);
    redc_row(v, u, x, fc);
    if (i + 1 < NW) {
      mul_row(u, v, x, a, b.w[i + 1]);
      redc_row(u, v, x, fc);
    }
  }
  // after row 7 the even accumulator is v (v[0] = 0) and the odd one u:
  // T = (v + u * 2^32 + x * 2^288) / 2^32 < 2^256 + p
  uint32_t t[NW];
  t[0] = ptx::add_cc(u[0], v[1]);
#pragma unroll
  for (int j = 1; j < NW - 1; j++) t[j] = ptx::addc_cc(u[j], v[j + 1]);
  t[NW - 1] = ptx::addc_cc(u[NW - 1], 0u);
  if constexpr (LAZY) {
    Fe r;
#pragma unroll
    for (int k = 0; k < NW; k++) r.w[k] = t[k];
    return r;
  } else {
    return fe_cond_sub(t, ptx::addc(x, 0u), fc);
  }
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConsts& fc) {
  return fe_mul_t<false>(a, b, fc);
}

// T mod 2^256 for T = (a*b + m*p) / 2^256: fe_mul without its subtract and
// without the carry out of the top. It is what perf/ubench_field.py's TPU
// bodies compute in radix 2^16 and 2^8, since m is the unique value below
// 2^256 whatever radix its digits are found in.
__device__ __forceinline__ Fe fe_mul_lazy(const Fe& a, const Fe& b, const FieldConsts& fc) {
  return fe_mul_t<true>(a, b, fc);
}

// -- XYZZ points (a = 0), the formulas of nova_tpu/ops/msm2.py ----------------
//
// The reference evaluates every branch of a formula and selects; these
// evaluate only the branch that is selected. The selected values are the
// same, so outputs are bit-identical.

// dbl-2008-s-1 without the identity mask.
__device__ __forceinline__ Pt xyzz_dbl_raw(const Pt& P, const FieldConsts& fc) {
  const Fe u = fe_dbl(P.y, fc);
  const Fe v = fe_mul(u, u, fc);
  const Fe xsq = fe_mul(P.x, P.x, fc);
  const Fe w = fe_mul(u, v, fc);
  const Fe s = fe_mul(P.x, v, fc);
  Pt R;
  R.zz = fe_mul(P.zz, v, fc);
  const Fe m = fe_add(fe_dbl(xsq, fc), xsq, fc);
  const Fe mm = fe_mul(m, m, fc);
  R.zzz = fe_mul(P.zzz, w, fc);
  R.x = fe_sub(mm, fe_dbl(s, fc), fc);
  const Fe t1 = fe_mul(m, fe_sub(s, R.x, fc), fc);
  const Fe t2 = fe_mul(w, P.y, fc);
  R.y = fe_sub(t1, t2, fc);
  return R;
}

// _xyzz_double_limbs: the identity maps to itself.
__device__ __forceinline__ Pt xyzz_double(const Pt& P, const FieldConsts& fc) {
  if (fe_is_zero(P.zz)) return P;
  return xyzz_dbl_raw(P, fc);
}

// add-2008-s general case, given u1 = X1*ZZ2, s1 = Y1*ZZZ2, pd = u2 - u1,
// r = s2 - s1.
__device__ __forceinline__ Pt xyzz_add_general(const Pt& P, const Pt& Q, const Fe& u1,
                                               const Fe& s1, const Fe& pd, const Fe& r,
                                               const FieldConsts& fc) {
  const Fe pp = fe_mul(pd, pd, fc);
  const Fe rr = fe_mul(r, r, fc);
  const Fe zzp = fe_mul(P.zz, Q.zz, fc);
  const Fe zzzp = fe_mul(P.zzz, Q.zzz, fc);
  const Fe ppp = fe_mul(pd, pp, fc);
  const Fe qq = fe_mul(u1, pp, fc);
  Pt R;
  R.zz = fe_mul(zzp, pp, fc);
  R.x = fe_sub(fe_sub(rr, ppp, fc), fe_dbl(qq, fc), fc);
  const Fe t1 = fe_mul(r, fe_sub(qq, R.x, fc), fc);
  const Fe t2 = fe_mul(s1, ppp, fc);
  R.zzz = fe_mul(zzzp, ppp, fc);
  R.y = fe_sub(t1, t2, fc);
  return R;
}

// _xyzz_add_limbs: complete XYZZ + XYZZ (identity, P = Q, P = -Q). The
// general formula runs first as straight-line code and the identity and
// P = +-Q cases are selected after it, so a chain of adds has no branch
// before its products: with the earlier 64-bit product a chained add took
// 12.0-12.9 us on a warp that runs alone against 19.3-20.4 us when the cases
// branched first (nova_tpu_torch/perf/bucket_stage.py on NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md section 6 has the times with fe_mul above).
// With IDENTITY false the caller has settled identity operands itself (K2,
// B6), so Q is dead after its six products and fewer registers stay live.
template <bool IDENTITY>
__device__ __forceinline__ Pt xyzz_add_cases(const Pt& P, const Pt& Q, const FieldConsts& fc) {
  const bool pz = IDENTITY && fe_is_zero(P.zz), qz = IDENTITY && fe_is_zero(Q.zz);
  const Fe u1 = fe_mul(P.x, Q.zz, fc);
  const Fe u2 = fe_mul(Q.x, P.zz, fc);
  const Fe s1 = fe_mul(P.y, Q.zzz, fc);
  const Fe s2 = fe_mul(Q.y, P.zzz, fc);
  const Fe pd = fe_sub(u2, u1, fc);
  const Fe r = fe_sub(s2, s1, fc);
  Pt R = xyzz_add_general(P, Q, u1, s1, pd, r, fc);
  if (pz) return Q;
  if (qz) return P;
  if (fe_is_zero(pd)) {
    if (fe_is_zero(r)) return xyzz_dbl_raw(P, fc);
    R.x = fe_one(fc);
    R.y = fe_one(fc);
    R.zz = fe_zero();
    R.zzz = fe_zero();
  }
  return R;
}

__device__ __forceinline__ Pt xyzz_add(const Pt& P, const Pt& Q, const FieldConsts& fc) {
  return xyzz_add_cases<true>(P, Q, fc);
}

// xyzz_add where neither operand is the identity.
__device__ __forceinline__ Pt xyzz_add_live(const Pt& P, const Pt& Q, const FieldConsts& fc) {
  return xyzz_add_cases<false>(P, Q, fc);
}

// Raw (16-bit limb) rows: an identity test of a coordinate, and a point
// moved from row `si` to row `di` without repacking.
__device__ __forceinline__ bool row_is_zero(const int32_t* __restrict__ src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int acc = 0;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int4 v = s[q];
    acc |= v.x | v.y | v.z | v.w;
  }
  return acc == 0;
}

__device__ __forceinline__ void pt_copy(int32_t* x, int32_t* y, int32_t* zz, int32_t* zzz,
                                        int64_t di, const int32_t* sx, const int32_t* sy,
                                        const int32_t* szz, const int32_t* szzz, int64_t si) {
  const int32_t* src[4] = {sx, sy, szz, szzz};
  int32_t* dst[4] = {x, y, zz, zzz};
#pragma unroll
  for (int c = 0; c < 4; c++) {
#pragma unroll
    for (int q = 0; q < 4; q++)
      reinterpret_cast<int4*>(dst[c] + di * NL)[q] =
          reinterpret_cast<const int4*>(src[c] + si * NL)[q];
  }
}

// _xyzz_add_limbs_fast: no doubling path; `bad` flags P = +-Q lanes whose
// result is garbage (both operands live, u1 == u2).
__device__ __forceinline__ Pt xyzz_add_fast(const Pt& P, const Pt& Q, bool& bad,
                                            const FieldConsts& fc) {
  bad = false;
  if (fe_is_zero(P.zz)) return Q;
  if (fe_is_zero(Q.zz)) return P;
  const Fe u1 = fe_mul(P.x, Q.zz, fc);
  const Fe u2 = fe_mul(Q.x, P.zz, fc);
  const Fe s1 = fe_mul(P.y, Q.zzz, fc);
  const Fe s2 = fe_mul(Q.y, P.zzz, fc);
  const Fe pd = fe_sub(u2, u1, fc);
  const Fe r = fe_sub(s2, s1, fc);
  bad = fe_is_zero(pd);
  return xyzz_add_general(P, Q, u1, s1, pd, r, fc);
}

// _affine_add_limbs_fast: round 0 of a "fast0" stage, where both operands
// are affine (ZZ = ZZZ = Montgomery one) or identities (ZZ = 0); 6 products.
// The result's ZZ/ZZZ are PP/PPP, or the surviving operand's ZZ when one is
// the identity. `bad` flags P = +-Q like xyzz_add_fast.
__device__ __forceinline__ Pt xyzz_affine_add_fast(const Pt& P, const Pt& Q, bool& bad,
                                                   const FieldConsts& fc) {
  bad = false;
  if (fe_is_zero(P.zz)) {
    Pt R = Q;
    R.zzz = Q.zz;
    return R;
  }
  if (fe_is_zero(Q.zz)) {
    Pt R = P;
    R.zzz = P.zz;
    return R;
  }
  const Fe pd = fe_sub(Q.x, P.x, fc);
  const Fe r = fe_sub(Q.y, P.y, fc);
  const Fe pp = fe_mul(pd, pd, fc);
  const Fe rr = fe_mul(r, r, fc);
  const Fe ppp = fe_mul(pd, pp, fc);
  const Fe qq = fe_mul(P.x, pp, fc);
  Pt R;
  R.x = fe_sub(fe_sub(rr, ppp, fc), fe_dbl(qq, fc), fc);
  R.y = fe_sub(fe_mul(r, fe_sub(qq, R.x, fc), fc), fe_mul(P.y, ppp, fc), fc);
  R.zz = pp;
  R.zzz = ppp;
  bad = fe_is_zero(pd);
  return R;
}

// msm3._madd_fast: XYZZ += affine (madd-2008-s, 10 muls), no doubling path.
// `live` is false for an identity operand (digit 0).
__device__ __forceinline__ Pt xyzz_madd_fast(const Pt& A, const Fe& X2, const Fe& Y2,
                                             bool live, bool& bad, const FieldConsts& fc) {
  bad = false;
  if (fe_is_zero(A.zz)) {
    Pt R;
    R.x = X2;
    R.y = Y2;
    R.zz = fe_one(fc);
    R.zzz = fe_one(fc);
    return R;
  }
  if (!live) return A;
  const Fe U2 = fe_mul(X2, A.zz, fc);
  const Fe S2 = fe_mul(Y2, A.zzz, fc);
  const Fe Pd = fe_sub(U2, A.x, fc);
  const Fe Rd = fe_sub(S2, A.y, fc);
  const Fe PP = fe_mul(Pd, Pd, fc);
  const Fe PPP = fe_mul(Pd, PP, fc);
  const Fe Qv = fe_mul(A.x, PP, fc);
  const Fe RR = fe_mul(Rd, Rd, fc);
  Pt R;
  R.x = fe_sub(fe_sub(RR, PPP, fc), fe_dbl(Qv, fc), fc);
  R.y = fe_sub(fe_mul(Rd, fe_sub(Qv, R.x, fc), fc), fe_mul(A.y, PPP, fc), fc);
  R.zz = fe_mul(A.zz, PP, fc);
  R.zzz = fe_mul(A.zzz, PPP, fc);
  bad = fe_is_zero(Pd);
  return R;
}

// Host side: the 17 words (p[8], one[8], n0) the Python wrappers pass.
inline FieldConsts load_consts(const uint32_t* words) {
  FieldConsts fc;
  for (int k = 0; k < NW; k++) fc.p[k] = words[k];
  for (int k = 0; k < NW; k++) fc.one[k] = words[NW + k];
  fc.n0 = words[2 * NW];
  return fc;
}

}  // namespace nt
