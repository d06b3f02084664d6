"""Sorted-bucket Pippenger MSM, msm1 (port of ``nova_tpu/ops/msm.py``).

The reference's msm/msm_small (src/provider/msm.rs:225-677) scatter points
into buckets with serial loops; here each window's buckets are built with
uniform vector steps:

  1. per window: digits d_i; a stable sort of the points by digit;
  2. within-segment ranks r_i = i - first_index(d_i) (searchsorted);
  3. R rounds of masked pairwise combines at strides 1, 2, 4, ...
     (Brent-Kung on the ranks): lane i absorbs lane i + 2^k when both share
     a digit and r_i = 0 mod 2^(k+1). R = ceil(log2(max bucket load)),
     from a host bincount, so the work is ~R*N point adds;
  4. the segment heads scattered into a dense bucket table per window;
  5. the tables summed across point chunks, then the window sum
     sum_b b*B_b by a Hillis-Steele suffix scan and a second scan;
  6. Horner across windows (c doublings a step).

All windows of a chunk run as one batch, so each combine round is one
point add (kernel K2) over W*chunk lanes; the doublings of a Horner step
are one launch of K3; the Montgomery products of the marshalling are K1.
msm1 has no kernel of its own: it is the program of the entry point
``nova_tpu_torch.graft_entry.entry``.
Inputs live on CUDA unless the caller names another device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nova_tpu_torch._device import resolve
from nova_tpu_torch.curves.points import (
    xyzz_add,
    xyzz_double,
    xyzz_from_affine,
    xyzz_select,
    xyzz_zero,
)
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops.msm2 import _next_pow2

# Window-points in flight per chunk: all windows of a chunk run as one
# batch, so a chunk holds _WINDOW_POINT_BUDGET // W points.
_WINDOW_POINT_BUDGET = 1 << 21


class DeviceBases:
    """Affine bases marshalled to a device: x, y (N, 16) Montgomery int32,
    inf (N,) bool, on `device` (CUDA unless given)."""

    def __init__(self, curve, points, device=None):
        self.curve = curve
        tf = TField(curve.base)
        self.tf = tf
        dev = resolve(device)
        self.x = tf.to_mont(torch.from_numpy(tf.pack([p.x for p in points])).to(dev))
        self.y = tf.to_mont(torch.from_numpy(tf.pack([p.y for p in points])).to(dev))
        self.inf = torch.tensor([p.infinity for p in points], dtype=torch.bool, device=dev)
        self.n = len(points)


def scalars_to_limbs16(scalars: Sequence[int]) -> np.ndarray:
    """(N, 16) uint32 16-bit little-endian limbs of the scalars."""
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype="<u2").reshape(len(scalars), 16).astype(np.uint32)


def digits_for_windows(limbs16: np.ndarray, c: int, num_windows: int) -> np.ndarray:
    """(W, N) uint32 window digits from (N, 16) 16-bit limbs."""
    n = limbs16.shape[0]
    out = np.zeros((num_windows, n), dtype=np.uint32)
    mask = (1 << c) - 1
    for w in range(num_windows):
        bit_lo = w * c
        li, ofs = bit_lo // 16, bit_lo % 16
        d = limbs16[:, li] >> ofs
        have = 16 - ofs
        if have < c and li + 1 < 16:
            d = d | (limbs16[:, li + 1] << have)
        out[w] = d & mask
    return out


def _limbs16_to_int(row) -> int:
    """One (16,) row of 16-bit limbs (array or tensor) -> int."""
    if isinstance(row, torch.Tensor):
        row = row.cpu().numpy()
    return int.from_bytes(np.asarray(row).astype(np.uint16).astype("<u2").tobytes(), "little")


def _window_bucket_tables(tf: TField, c: int, rounds: int, d, bx, by, binf) -> dict:
    """Every window of one chunk up to its dense bucket table: d (W, n)
    int64 digits over the chunk's bases bx, by (n, 16), binf (n,). Returns
    a dict of (W, 2^c, 16) XYZZ tables (bucket 0 the identity)."""
    W, n = d.shape
    dev = d.device
    ds, order = torch.sort(d, dim=1, stable=True)
    pinf = binf[order] | (ds == 0)
    pts = xyzz_from_affine(tf, bx[order], by[order], pinf)
    idx = torch.arange(n, device=dev)
    rank = idx - torch.searchsorted(ds, ds, side="left")
    for k in range(rounds):
        shift = 1 << k
        partner = torch.clamp(idx + shift, max=n - 1)
        q = {key: v[:, partner] for key, v in pts.items()}
        same = (ds[:, partner] == ds) & ((idx + shift) < n)
        active = same & ((rank & ((shift << 1) - 1)) == 0)
        pts = xyzz_select(tf, active, xyzz_add(tf, pts, q), pts)
    heads = rank == 0
    ids = torch.where(heads, ds, 0)
    vals = xyzz_select(tf, heads, pts, xyzz_zero(tf, pts["x"]))
    rows = torch.arange(W, device=dev)[:, None].expand(W, n)
    buckets = xyzz_zero(tf, pts["x"].new_zeros((W, 1 << c, NUM_LIMBS)))
    out = {}
    for key, table in buckets.items():
        table = table.clone()
        table[rows, ids] = vals[key]
        table[:, 0] = buckets[key][:, 0]  # bucket 0 holds nothing
        out[key] = table
    return out


def _suffix_scan(tf: TField, c: int, S: dict) -> dict:
    """Hillis-Steele suffix sums over the 2^c buckets of (W, 2^c, 16)
    tables: S[b] = sum_{b' >= b} S[b'], in c rounds."""
    nb = 1 << c
    bidx = torch.arange(nb, device=S["x"].device)
    for k in range(c):
        shift = 1 << k
        partner = torch.clamp(bidx + shift, max=nb - 1)
        q = {key: v[:, partner] for key, v in S.items()}
        S = xyzz_select(tf, (bidx + shift) < nb, xyzz_add(tf, S, q), S)
    return S


def _bucket_table_to_sum(tf: TField, c: int, buckets: dict) -> dict:
    """Weighted bucket reduction sum_b b*B[b] of (W, 2^c, 16) tables ->
    (W, 16): the suffix sums S, then sum_{k >= 1} S[k] by a second scan."""
    S = _suffix_scan(tf, c, buckets)
    bidx = torch.arange(1 << c, device=S["x"].device)
    S1 = xyzz_select(tf, bidx >= 1, S, xyzz_zero(tf, S["x"]))
    return {k: v[:, 0] for k, v in _suffix_scan(tf, c, S1).items()}


def _chunk_size(n: int, num_windows: int) -> int:
    """Points per chunk: the budget over the windows, rounded down to a
    power of two FIRST (halving a non-power of two never divides a
    power-of-two n and would end at chunk = 1), then halved until it
    divides n."""
    chunk = min(max(1, _WINDOW_POINT_BUDGET // max(1, num_windows)), n)
    chunk = 1 << (chunk.bit_length() - 1)
    while n % chunk:
        chunk //= 2
    return chunk


def msm_program(tf: TField, c: int, rounds: int, d_all, bx, by, binf):
    """msm1's program: d_all (W, N) window digits (any integer dtype), bases
    bx, by (N, 16) Montgomery, binf (N,). Chunks of points build per-window
    bucket tables that add up across chunks; the weighted bucket reduction
    and the Horner finish run once. Returns (x, y, zz, zzz), each (16,)
    int32 in standard form."""
    d_all = d_all.long()
    W, n = d_all.shape
    chunk = _chunk_size(n, W)
    acc = xyzz_zero(tf, bx.new_zeros((W, 1 << c, NUM_LIMBS)))
    for a in range(0, n, chunk):
        b = a + chunk
        tables = _window_bucket_tables(tf, c, rounds, d_all[:, a:b], bx[a:b], by[a:b],
                                       binf[a:b])
        acc = xyzz_add(tf, acc, tables)
    window_pts = _bucket_table_to_sum(tf, c, acc)
    # Horner from the top window down: acc = 2^c * acc + S_w
    total = xyzz_zero(tf, bx.new_zeros((1, NUM_LIMBS)))
    for w in range(W - 1, -1, -1):
        total = xyzz_add(tf, xyzz_double(tf, total, c),
                         {k: v[w : w + 1] for k, v in window_pts.items()})
    out = {k: tf.from_mont(v)[0] for k, v in total.items()}
    return out["x"], out["y"], out["zz"], out["zzz"]


def msm_device(scalars: Sequence[int], bases=None,
               device_bases: Optional[DeviceBases] = None,
               window: Optional[int] = None):
    """MSM of host int scalars on the bases' device (marshalled on CUDA
    unless `device_bases` lives elsewhere). Only the windows the widest
    scalar covers run (the reference's msm_small routing), their count
    rounded up to a power of two."""
    from nova_tpu_torch.curves.spec import AffinePoint

    n = len(scalars)
    if n == 0:
        raise ValueError("empty msm")
    if device_bases is None:
        device_bases = DeviceBases(bases[0].curve, bases)
    curve = device_bases.curve
    tf = TField(curve.base)
    dev = device_bases.x.device

    n_pad = max(2, _next_pow2(n))
    limbs = np.zeros((n_pad, 16), dtype=np.uint32)
    limbs[:n] = scalars_to_limbs16(scalars)
    bx, by, binf = device_bases.x, device_bases.y, device_bases.inf
    if device_bases.n < n_pad:
        pad = n_pad - device_bases.n
        bx = torch.cat([bx, bx.new_zeros((pad, NUM_LIMBS))])
        by = torch.cat([by, by.new_zeros((pad, NUM_LIMBS))])
        binf = torch.cat([binf, binf.new_ones((pad,))])
    else:
        bx, by, binf = bx[:n_pad], by[:n_pad], binf[:n_pad]

    if window is None:
        # the bucket tables add up across chunks, so their reduction runs
        # once and wide windows pay off from 2^14 points (the reference's
        # choice)
        window = 13 if (1 << 14) <= n_pad <= (1 << 18) else 8
    num_bits = max((int(s).bit_length() for s in scalars), default=1)
    num_bits = max(1, min(num_bits, curve.scalar.num_bits))
    full_windows = (curve.scalar.num_bits + window - 1) // window
    num_windows = min(_next_pow2((num_bits + window - 1) // window), full_windows)
    digits = digits_for_windows(limbs, window, num_windows)

    # rounds cover the largest bucket load within a chunk (the combine runs
    # per chunk), rounded up to an even count, at most log2(chunk)
    chunk = _chunk_size(n_pad, num_windows)
    max_load = 1
    for w in range(num_windows):
        for off in range(0, n_pad, chunk):
            counts = np.bincount(digits[w, off : off + chunk])
            if counts.size > 1:
                max_load = max(max_load, int(counts[1:].max(initial=1)))
    rounds = max(2, int(np.ceil(np.log2(max_load))) if max_load > 1 else 2)
    rounds = min(((rounds + 1) // 2) * 2, max(1, chunk.bit_length() - 1))

    d_dev = torch.from_numpy(digits.astype(np.int64)).to(dev)
    x, y, zz, zzz = msm_program(tf, window, rounds, d_dev, bx, by, binf)
    f = curve.base
    zzv = _limbs16_to_int(zz)
    if zzv == 0:
        return AffinePoint.identity(curve)
    return AffinePoint(curve, f.mul(_limbs16_to_int(x), f.inv(zzv)),
                       f.mul(_limbs16_to_int(y), f.inv(_limbs16_to_int(zzz))))
