"""The yardstick of an MSM's roofline share: the least time that an MSM of
n points and b-bit scalars could take on one H100 SXM, from the data
sheet's peaks. It depends on n and b alone, never on how the program does
the MSM, so a later change to the MSM changes the time measured and not
this bound.

- Bytes: each input read once, n affine bases (64 bytes) and n scalars
  (ceil(b / 8) bytes), over 3.35e12 bytes/s.
- Work: Pippenger's least count of point additions over window widths c,
  ceil(b / c) windows of n mixed additions (XYZZ madd: 10 field products)
  into 2^(c - 1) signed-digit buckets, then 2 full additions a bucket
  (XYZZ add: 14 products) for the running sums; a 256-bit Montgomery
  product is 264 32-bit integer multiply-adds (8 x 8 limb products, low
  and high halves, and the same again to reduce, with one quotient word a
  limb); over 132 SMs x 64 lanes x 1.98 GHz."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_IMAD_S = 132 * 64 * 1.98e9
IMAD_PER_PRODUCT = 264
MADD_PRODUCTS = 10
ADD_PRODUCTS = 14


def msm_bytes(n: int, bits: int) -> int:
    return n * (64 + -(-bits // 8))


def msm_imads(n: int, bits: int) -> int:
    return min(-(-bits // c) * (n * MADD_PRODUCTS + (1 << c) * ADD_PRODUCTS)
               for c in range(2, 25)) * IMAD_PER_PRODUCT


def msm_least_s(n: int, bits: int) -> float:
    return max(msm_bytes(n, bits) / PEAK_BYTES_S, msm_imads(n, bits) / PEAK_IMAD_S)
