// 256-bit Montgomery field arithmetic and XYZZ point formulas shared by
// every kernel of the port (field_kernels.cu: K1-K3, msm_kernels.cu: K4-K5,
// stage_kernel.cu: B6).
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

// t - p when t >= p or `overflow` is set, else t (one conditional subtract,
// modulo 2^256).
__device__ __forceinline__ Fe fe_cond_sub(const uint32_t t[NW], uint32_t overflow,
                                          const FieldConsts& fc) {
  uint32_t d[NW];
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)t[k] - fc.p[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool need = (borrow == 0u) || (overflow != 0u);
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; k++) r.w[k] = need ? d[k] : t[k];
  return r;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t t[NW];
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t s = (uint64_t)a.w[k] + b.w[k] + c;
    t[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return fe_cond_sub(t, c, fc);
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const FieldConsts& fc) {
  return fe_add(a, a, fc);
}

// a - b, plus p (modulo 2^256) when the subtraction borrows.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t d[NW];
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)a.w[k] - b.w[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const uint32_t mask = 0u - borrow;
  Fe r;
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t s = (uint64_t)d[k] + (fc.p[k] & mask) + c;
    r.w[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return r;
}

// Montgomery product a*b*2^-256 mod p, CIOS over 32-bit words.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConsts& fc) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * fc.n0;
    s = (uint64_t)m * fc.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      s = (uint64_t)m * fc.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  return fe_cond_sub(t, t[NW], fc);
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
// before its products: a chained add takes 12.7-12.9 us on a warp that runs
// alone against 19.3-20.4 us when the cases branch first, and the card
// completes 1,854 adds/us against 1,370-1,447 (nova_tpu_torch/perf/
// bucket_stage.py on NVIDIA H100 80GB HBM3, 700.00 W). An identity operand
// costs the general formula's work all the same.
__device__ __forceinline__ Pt xyzz_add(const Pt& P, const Pt& Q, const FieldConsts& fc) {
  const bool pz = fe_is_zero(P.zz), qz = fe_is_zero(Q.zz);
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
