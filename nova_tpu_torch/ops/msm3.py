"""Fixed-base MSM by column-serial segmented accumulation (port of
``nova_tpu/ops/msm3.py``).

  1. signed c-bit digits over the joint fixed-base window space (window-
     shifted bases fold the 2^(c*w) weight into the base, so all windows
     share one bucket space; see msm2._precompute_shifted). Scalars are
     reduced to the symmetric range |s'| <= (p-1)/2 with the sign folded
     into the digits, so 255-bit scalars need W = 16 windows at c = 16.
  2. ONE stable ``torch.sort`` of the W*n |digit| keys and a gather of the
     points into an (R, C) grid: sorted element j*R + i lands at row i,
     column j, and the grid is stored row-major so neighbouring columns
     are neighbours in memory (coalesced row reads in K4).
  3. kernel K4 (``accum``): one thread per column walks its R rows;
     acc += P (10-mul mixed add) while the digit repeats, else acc is
     flushed to that row's slot and restarts at P.
  4. bucket recovery by gather (``_bucket_totals``): bucket b's run ends at
     sorted position C_b - 1 with C_b = searchsorted(sorted_d, b, right);
     its partial was flushed at row (C_b-1)%R + 1 of column (C_b-1)//R,
     or is the column-end carry. The C column-end carries (non-decreasing
     digits) go through a suffix pass of complete adds (C <= 256) or
     through K4 again (level 2, XYZZ input, complete adds) and a suffix
     pass over the level-2 carries.
  5. weighted bucket reduction (msm2._bucket_reduce, kernel K5) and the
     host finish.

Fast adds flag degenerate lanes (P = +-acc); the MSM reads the flag once
and reruns K4 in complete mode when it is set (never for distinct bases).

Not ported: the TPU's sort workarounds (``_move_tail``,
``_sortpack_split``, the two sorts of ``_perm_tail``), which exist only
to avoid XLA:TPU compile hangs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nova_tpu_torch import _build
from nova_tpu_torch._device import on_cuda
from nova_tpu_torch.curves.points import xyzz_add
from nova_tpu_torch.fields.kernels import (
    check_i32,
    xyzz_add_limbs,
    xyzz_add_limbs_fast,
)
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops.msm2 import (
    KEYS,
    DeviceBases2,
    _as_limbs,
    _bucket_reduce,
    _from_limbs,
    _next_pow2,
    _xyzz_row_to_affine,
)

_I32 = torch.int32
_I64 = torch.int64

# (R, C) grid: C is the largest power of two <= _C_MAX dividing n_s that
# leaves at least _R_MIN rows. One K4 thread per column, so C sets the
# kernel's parallelism and R its serial depth.
_C_MAX = 1 << 15
_R_MIN = 32
# level-2 grid over the C column-end carries: rows per column
_R2 = 8
# per-dispatch point cap; larger MSMs run in chunks summed on the host
_CHUNK_MAX = 1 << 18


def _num_windows(c: int, max_bits: int = None) -> int:
    """Window count covering `max_bits`-bit scalars (default: full 255-bit
    field scalars)."""
    if max_bits is None:
        return (255 + c - 1) // c + 1
    # the signed-digit offset needs u = s + offset < 2^(c*W)
    return max(1, -(-(max_bits + 2) // c))


def _windows_for(c: int, scalar_p: int, max_bits: int = None) -> int:
    """The caller's max_bits when given, else the symmetric-range bound
    |s'| <= (p-1)/2."""
    if max_bits is not None:
        return _num_windows(c, max_bits)
    return _num_windows(c, scalar_p.bit_length() - 1)


def _sym_reduce_host(scalars, p: int):
    """Host symmetric-range reduction: (|s'| list, negs bool array)."""
    half = p >> 1
    out = []
    negs = np.zeros(len(scalars), dtype=bool)
    for i, sc in enumerate(scalars):
        sc = int(sc) % p
        if sc > half:
            out.append(p - sc)
            negs[i] = True
        else:
            out.append(sc)
    return out, negs


def _offset_int(c: int, W: int = None) -> int:
    """sum_w 2^(c-1) * 2^(c*w): with it added, the unsigned base-2^c digits
    u_w of a scalar give signed digits d_w = u_w - 2^(c-1) with no carry
    chain."""
    if W is None:
        W = _num_windows(c)
    return sum(1 << (c - 1 + c * w) for w in range(W))


def _off_limbs16(c: int, W: int = None) -> list:
    if W is None:
        W = _num_windows(c)
    off = _offset_int(c, W)
    L = (c * W + 15) // 16
    return [(off >> (16 * i)) & 0xFFFF for i in range(L)]


def _scalar_ulimbs(scalars, n_pad: int, c: int, W: int = None) -> np.ndarray:
    """(n_pad, L) int32 16-bit limbs of s + _offset_int(c, W); pad rows
    encode scalar 0 so their digits stay 0 (inert)."""
    if W is None:
        W = _num_windows(c)
    off = _offset_int(c, W)
    nbytes = (c * W + 15) // 16 * 2
    L = nbytes // 2
    off_row = np.frombuffer(off.to_bytes(nbytes, "little"), dtype="<u2")
    limbs = np.broadcast_to(off_row.astype(np.int32), (n_pad, L)).copy()
    if len(scalars):
        buf = b"".join((int(s) + off).to_bytes(nbytes, "little") for s in scalars)
        limbs[: len(scalars)] = np.frombuffer(buf, dtype="<u2").reshape(
            len(scalars), L
        )
    return limbs


def offset_digits_device(ulimbs, c: int, W: int = None, negs=None):
    """(N, L) 16-bit limbs of s+offset -> (W, N) int32 signed digits by bit
    slicing; `negs` (N,) bool flips the sign of every digit of the flagged
    scalars (the symmetric-range reduction's point negation)."""
    n, L = ulimbs.shape
    if W is None:
        W = _num_windows(c)
    u = ulimbs.long()
    mask = (1 << c) - 1
    half = 1 << (c - 1)
    outs = []
    for w in range(W):
        bit_lo = w * c
        li, ofs = bit_lo // 16, bit_lo % 16
        if li >= L:
            d = torch.zeros((n,), dtype=_I64, device=u.device)
        else:
            d = u[:, li] >> ofs
            have = 16 - ofs
            j = li + 1
            while have < c and j < L:
                d = d | (u[:, j] << have)
                have += 16
                j += 1
        outs.append((d & mask) - half)
    ds = torch.stack(outs).to(_I32)
    if negs is not None:
        ds = torch.where(negs[None, :], -ds, ds)
    return ds


def _ripple(vals, L: int):
    """(n, L) int64 limb sums -> exact 16-bit limbs (carry out dropped)."""
    out = []
    carry = None
    for i in range(L):
        v = vals[:, i] if carry is None else vals[:, i] + carry
        out.append(v & 0xFFFF)
        carry = v >> 16
    return torch.stack(out, dim=1)


def add_offset_device(s16, c: int, W: int = None):
    """(n, 16) standard-form 16-bit limbs -> (n, L) int32 limbs of
    s + _offset_int(c, W). With a small W the offset spans fewer limbs
    than the scalar; limbs are padded to a common width so digit
    extraction below window W stays exact."""
    n = s16.shape[0]
    offl = _off_limbs16(c, W)
    L = max(len(offl), s16.shape[1])
    a = s16.long()
    if L > s16.shape[1]:
        a = torch.cat([a, a.new_zeros((n, L - s16.shape[1]))], dim=1)
    offt = torch.tensor(offl + [0] * (L - len(offl)), dtype=_I64, device=a.device)
    return _ripple(a + offt, L).to(_I32)


def _sym_reduce_device(sf: TField, s16):
    """Device symmetric-range reduction on (n, 16) 16-bit-limb standard
    scalars: returns (|s'| limbs, negs) with s' = p - s when s > (p-1)/2."""
    p = sf.spec.p
    L = s16.shape[1]
    half = (p - 1) >> 1
    hl = [(half >> (16 * i)) & 0xFFFF for i in range(L)]
    pl = torch.tensor(
        [(p >> (16 * i)) & 0xFFFF for i in range(L)], dtype=_I64, device=s16.device
    )
    s = s16.long()
    gt = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
    eq = torch.ones_like(gt)
    for i in range(L - 1, -1, -1):
        gt = gt | (eq & (s[:, i] > hl[i]))
        eq = eq & (s[:, i] == hl[i])
    # p - s = p + (~s & 0xffff) + 1 modulo 2^(16 L)
    t = pl + (0xFFFF - s)
    t[:, 0] += 1
    psub = _ripple(t, L)
    return torch.where(gt[:, None], psub, s).to(_I32), gt


# ---------------------------------------------------------------------------
# kernel K4: the accumulate
# ---------------------------------------------------------------------------


def _madd_fast(o, ACC, X2, Y2, live):
    """XYZZ += affine mixed add (madd-2008-s, 10 muls), without the doubling
    path. `live` masks lanes whose affine operand is real. Returns (coords,
    bad) where bad flags degenerate P = +-Q lanes."""
    X1, Y1, ZZ1, ZZZ1 = ACC
    U2 = o.mul(X2, ZZ1)
    S2 = o.mul(Y2, ZZZ1)
    Pd = o.sub(U2, X1)
    Rd = o.sub(S2, Y1)
    PP = o.mul(Pd, Pd)
    PPP = o.mul(Pd, PP)
    Q = o.mul(X1, PP)
    RR = o.mul(Rd, Rd)
    X3 = o.sub(o.sub(RR, PPP), o.dbl(Q))
    Y3 = o.sub(o.mul(Rd, o.sub(Q, X3)), o.mul(Y1, PPP))
    ZZ3 = o.mul(ZZ1, PP)
    ZZZ3 = o.mul(ZZZ1, PPP)

    p_zero = o.is_zero(ZZ1)
    q_zero = ~live
    one = o.one(X1)

    def pick(res, pc, qc):
        out = o.sel(p_zero, qc, res)
        return o.sel(q_zero & ~p_zero, pc, out)

    out = (pick(X3, X1, X2), pick(Y3, Y1, Y2), pick(ZZ3, ZZ1, one),
           pick(ZZZ3, ZZZ1, one))
    return out, o.is_zero(Pd) & ~p_zero & ~q_zero


def accum_plain(tf: TField, d_grid, pts: dict, mode: str):
    """Plain K4 (msm3._accum_xla semantics, plus the fast modes). d_grid:
    (R, C) int32 |digits|; pts: dict of (R, C, 16) int32 rows, x/y only
    (affine input) or x/y/zz/zzz. Returns (flush dict of (R, C, 16),
    colend dict of (C, 16), flag (C,) int32)."""
    o = tf.ops(d_grid.device)
    R, C = d_grid.shape
    affine = "zz" not in pts
    one = o.r.expand(C, NUM_LIMBS)
    zero = torch.zeros((C, NUM_LIMBS), dtype=_I64, device=d_grid.device)
    acc = (zero, zero, zero, zero)
    prev = torch.full((C,), -1, dtype=_I32, device=d_grid.device)
    bad_any = torch.zeros((C,), dtype=torch.bool, device=d_grid.device)
    flush = []
    for i in range(R):
        d = d_grid[i]
        live = d != 0
        boundary = d != prev
        x, y = pts["x"][i].long(), pts["y"][i].long()
        if affine:
            z = torch.where(live[:, None], one, 0)
            q = (x, y, z, z)
        else:
            q = (x, y, pts["zz"][i].long(), pts["zzz"][i].long())
        if mode == "fast":
            if affine:
                s, bad = _madd_fast(o, acc, x, y, live)
            else:
                s, bad = xyzz_add_limbs_fast(o, acc, q)
            bad_any = bad_any | (bad & ~boundary)
        else:
            s = xyzz_add_limbs(o, acc, q)
        b = boundary[:, None]
        flush.append(tuple(torch.where(b, a, 0) for a in acc))
        acc = tuple(torch.where(b, qc, sc) for qc, sc in zip(q, s))
        prev = d
    fl = {k: torch.stack([f[c] for f in flush]).to(_I32) for c, k in enumerate(KEYS)}
    return fl, _from_limbs(acc), bad_any.to(_I32)


def accum(tf: TField, d_grid, pts: dict, mode: str):
    """K4: segmented accumulation down the columns of the (R, C) grid; see
    accum_plain for the contract. Modes: "fast" (degenerate lanes flagged)
    or "complete"."""
    assert mode in ("fast", "complete"), mode
    keys = KEYS if "zz" in pts else KEYS[:2]
    ins = [pts[k] for k in keys]
    if not on_cuda(d_grid, *ins):
        return accum_plain(tf, d_grid, pts, mode)
    R, C = d_grid.shape
    d_grid, *ins = check_i32(d_grid, *ins)
    if len(ins) == 2:
        ins = ins + ins  # zz/zzz pointers unused in affine mode
    flush = {k: ins[0].new_empty((R, C, NUM_LIMBS)) for k in KEYS}
    colend = {k: ins[0].new_empty((C, NUM_LIMBS)) for k in KEYS}
    flag = torch.empty((C,), dtype=_I32, device=d_grid.device)
    with torch.cuda.device(d_grid.device):
        err = _build.lib().nt_accum(
            int(len(keys) == 2), int(mode == "fast"), d_grid.data_ptr(),
            *(t.data_ptr() for t in ins), *(flush[k].data_ptr() for k in KEYS),
            *(colend[k].data_ptr() for k in KEYS), flag.data_ptr(), R, C,
            tf.consts_ptr, _build.stream_of(d_grid),
        )
        _build.check(err, "accum")
        _build.LAUNCHES["accum"] += 1
    return flush, colend, flag


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _grid_shape(n_s: int):
    """(R, C) with R*C == n_s: C the largest power of two <= _C_MAX that
    divides n_s and leaves at least _R_MIN rows (at least 1 column)."""
    C = 1
    while (C * 2 <= _C_MAX and n_s % (C * 2) == 0
           and n_s // (C * 2) >= _R_MIN):
        C *= 2
    return n_s // C, C


_GRID_IDX: dict = {}


def _grid_index(R: int, C: int, device):
    """Sorted position of each row-major grid cell: cell (i, j) -> j*R + i."""
    key = (R, C, str(device))
    if key not in _GRID_IDX:
        ar = torch.arange(R * C, device=device)
        _GRID_IDX[key] = ar.view(C, R).t().reshape(-1)
    return _GRID_IDX[key]


def _sortpack(d, fx, fy, fyneg, finf):
    """digits + window-shifted bases -> (sorted_d (n_s,) int32 ascending,
    st) where st = (d_grid (R, C), {"x", "y": (R, C, 16)}) is the sorted
    order laid out on the row-major grid, y negated where the digit is
    negative. Infinity bases get digit 0 (inert)."""
    n_s = d.shape[0]
    R, C = _grid_shape(n_s)
    absd = torch.where(finf, 0, d.abs())
    sorted_d, sidx = torch.sort(absd, stable=True)
    src = sidx[_grid_index(R, C, d.device)]
    neg = (d < 0)[src][:, None]
    px = fx[src]
    py = torch.where(neg, fyneg[src], fy[src])
    d_grid = sorted_d[_grid_index(R, C, d.device)].view(R, C)
    pts = {"x": px.view(R, C, NUM_LIMBS), "y": py.view(R, C, NUM_LIMBS)}
    return sorted_d, (d_grid, pts)


def _suffix_segmented(tf: TField, digs, vals: dict):
    """Masked Hillis-Steele suffix sums over (m, 16) XYZZ rows grouped by
    equal digits: afterwards the FIRST row of each run holds the run total.
    m must be a power of two (pad with digit -1)."""
    m = digs.shape[0]
    rounds = int(np.ceil(np.log2(max(2, m))))
    iota = torch.arange(m, device=digs.device)
    for r in range(rounds):
        s = 1 << r
        keep = iota < (m - s)
        dsh = torch.where(keep, torch.roll(digs, -s), -2)
        same = (keep & (dsh == digs))[:, None]
        vsh = {k: torch.where(same, torch.roll(v, -s, dims=0), 0)
               for k, v in vals.items()}
        added = xyzz_add(tf, vals, vsh)
        vals = {k: torch.where(same, added[k], vals[k]) for k in vals}
    return vals


def _run_heads(dend, bs):
    """(head position, present) of each digit of `bs` in sorted `dend`."""
    lh = torch.searchsorted(dend, bs)
    has = torch.searchsorted(dend, bs, right=True) > lh
    return torch.where(has, lh, 0), has


def _take(vals: dict, idx, mask) -> dict:
    return {k: torch.where(mask[:, None], v[idx], 0) for k, v in vals.items()}


def _tails(seq, bs, R: int, flush: dict) -> dict:
    """For each digit of `bs`, the partial sum of its run in the sorted
    sequence `seq` laid on an (R, len(seq)/R) column-major grid: a run
    ending at position t is flushed at row t%R + 1 of column t//R, unless
    it touches the column end (then it is that column's end carry and
    reads as zero here, as do absent digits)."""
    right = torch.searchsorted(seq, bs, right=True)
    exists = right > torch.searchsorted(seq, bs)
    t = right - 1
    e = t % R
    take = exists & (e < R - 1)
    return _take(
        {k: v.view(-1, NUM_LIMBS) for k, v in flush.items()},
        torch.where(take, (e + 1) * (seq.shape[0] // R) + t // R, 0), take,
    )


def _bucket_totals(tf: TField, sorted_d, flush, colend, d_grid, nb: int):
    """Per-bucket totals (dict of (nb, 16) XYZZ rows) from the level-1
    flush/colend, fixing up runs that span columns with the column-end
    carries."""
    R, C = d_grid.shape
    dev = sorted_d.device
    bs = torch.arange(1, nb + 1, dtype=sorted_d.dtype, device=dev)
    tail1 = _tails(sorted_d, bs, R, flush)
    dend = d_grid[R - 1].contiguous()  # (C,) non-decreasing
    if C <= 256:  # C is a power of two: one suffix pass finishes it
        sums = _suffix_segmented(tf, dend, colend)
        return xyzz_add(tf, tail1, _take(sums, *_run_heads(dend, bs)))

    # level 2: the C carries on an (R2, C2) grid through K4 (complete adds)
    C2 = max(128, C // _R2)
    R2 = C // C2
    gi = _grid_index(R2, C2, dev)
    flush2, colend2, _ = accum(
        tf, dend[gi].view(R2, C2),
        {k: v[gi].view(R2, C2, NUM_LIMBS) for k, v in colend.items()},
        "complete",
    )
    tail2 = _tails(dend, bs, R2, flush2)
    # level 3: suffix pass over the C2 level-2 carries
    dend2 = dend[gi].view(R2, C2)[R2 - 1].contiguous()
    sums3 = _suffix_segmented(tf, dend2, colend2)
    acc = xyzz_add(tf, tail1, tail2)
    return xyzz_add(tf, acc, _take(sums3, *_run_heads(dend2, bs)))


def _msm3_dispatch(bf: TField, sorted_d, st, c: int):
    """Queue accumulate + finish without waiting for the device; returns a
    handle for _msm3_collect (lets a batch queue every MSM first)."""
    d_grid, pts = st
    out, flag = _msm3_finish(bf, sorted_d, d_grid, pts, c, "fast")
    return (bf, sorted_d, st, c, out, flag)


def _msm3_finish(bf: TField, sorted_d, d_grid, pts, c: int, mode: str):
    flush, colend, flag = accum(bf, d_grid, pts, mode)
    totals = _bucket_totals(bf, sorted_d, flush, colend, d_grid, 1 << (c - 1))
    s = _bucket_reduce(bf, totals)
    return {k: bf.from_mont(v) for k, v in s.items()}, flag.any()


def _msm3_collect(pending):
    """Wait for a dispatched MSM; rerun K4 in complete mode (reusing the
    sort) when a degenerate fast add was flagged."""
    bf, sorted_d, st, c, out, flag = pending
    if bool(flag.item()):
        d_grid, pts = st
        out, _ = _msm3_finish(bf, sorted_d, d_grid, pts, c, "complete")
    return {k: v.cpu() for k, v in out.items()}


def _prep_mont(db: DeviceBases2, marr, c: int, W: int):
    """(n, 16) Montgomery scalars -> padded (sorted_d, st)."""
    sf = TField(db.curve.scalar)
    n = int(marr.shape[0])
    n_pad = max(512, _next_pow2(n))
    if n_pad != n:
        marr = torch.cat([marr, marr.new_zeros((n_pad - n, NUM_LIMBS))])
    fx, fy, fyneg, finf = _windowed(db, c, n_pad, W)
    sabs, negs = _sym_reduce_device(sf, sf.from_mont(marr))
    u = add_offset_device(sabs, c, W)
    d = offset_digits_device(u, c, W, negs).reshape(W * n_pad)
    return _sortpack(d, fx, fy, fyneg, finf)


def _windowed(db: DeviceBases2, c: int, n_pad: int, W: int):
    """The first W windows of the shifted bases (rows [0, W*n_pad))."""
    k = W * n_pad
    return tuple(t[:k] for t in db.fixed(c, n_pad))


def _effective_window(window: int, t) -> int:
    """The window to use: 2..17 (K5 reduces at most 256^2 buckets); on CPU
    tensors (the plain versions) capped at 9, as the reference's XLA path
    does, since wide windows make the bucket table huge."""
    if not 2 <= window <= 17:
        raise ValueError(f"window must be in 2..17, got {window}")
    return window if t.device.type == "cuda" else min(window, 9)


def _db_slice(db: DeviceBases2, a: int, b: int) -> DeviceBases2:
    """Sub-range view of a marshalled base set (own precompute cache)."""
    cache = db.__dict__.setdefault("_slices", {})
    if (a, b) not in cache:
        cache[(a, b)] = DeviceBases2.from_tensors(
            db.curve, db.x[a:b], db.y[a:b], db.inf[a:b]
        )
    return cache[(a, b)]


def msm_device3_mont(marr, device_bases: DeviceBases2, window: int = 16,
                     max_bits: int = None):
    """Fixed-base MSM over a (n, 16) int32 Montgomery-form tensor of scalars
    in the curve's scalar field (an FVec's .m), on the tensor's device.

    `max_bits` is the caller's bound on scalar bit width: only enough
    windows to cover it are used. Scalars above the bound give WRONG
    results, as in the reference."""
    n = int(marr.shape[0])
    curve = device_bases.curve
    if n > _CHUNK_MAX:
        from nova_tpu_torch.curves.spec import AffinePoint

        acc = AffinePoint.identity(curve)
        for a in range(0, n, _CHUNK_MAX):
            b = min(a + _CHUNK_MAX, n)
            acc = acc.add(msm_device3_mont(
                marr[a:b], _db_slice(device_bases, a, b), window=window,
                max_bits=max_bits,
            ))
        return acc
    window = _effective_window(window, marr)
    W = _windows_for(window, curve.scalar.p, max_bits)
    sorted_d, st = _prep_mont(device_bases, marr, window, W)
    out = _msm3_collect(_msm3_dispatch(TField(curve.base), sorted_d, st, window))
    return _xyzz_row_to_affine(curve, out)


def msm_device3_mont_batch(marrs, device_bases: DeviceBases2,
                           window: int = 16, max_bits: int = None):
    """A batch of fixed-base MSMs over one key: every MSM is queued on the
    device before the first result is read, so the host never idles the
    card between them. Results equal sequential calls. Above the chunk
    cap it falls back to sequential calls."""
    if not marrs:
        return []
    if any(int(m.shape[0]) > _CHUNK_MAX for m in marrs):
        return [msm_device3_mont(m, device_bases, window=window,
                                 max_bits=max_bits) for m in marrs]
    curve = device_bases.curve
    bf = TField(curve.base)
    window = _effective_window(window, marrs[0])
    W = _windows_for(window, curve.scalar.p, max_bits)
    pend = []
    for marr in marrs:
        sorted_d, st = _prep_mont(device_bases, marr, window, W)
        pend.append(_msm3_dispatch(bf, sorted_d, st, window))
    return [_xyzz_row_to_affine(curve, _msm3_collect(p)) for p in pend]


def msm_device3(scalars: Sequence[int], bases=None,
                device_bases: Optional[DeviceBases2] = None,
                window: int = 16, max_bits: int = None, device=None):
    """Fixed-base MSM of host int scalars through the same engine. Bases
    are marshalled/precomputed once per (key, size) via DeviceBases2
    (built on `device`, CUDA by default, when only `bases` is given)."""
    n = len(scalars)
    if n == 0:
        raise ValueError("empty msm")
    if device_bases is None:
        device_bases = DeviceBases2(bases[0].curve, bases, device=device)
    curve = device_bases.curve
    if n > _CHUNK_MAX:
        from nova_tpu_torch.curves.spec import AffinePoint

        acc = AffinePoint.identity(curve)
        for a in range(0, n, _CHUNK_MAX):
            b = min(a + _CHUNK_MAX, n)
            acc = acc.add(msm_device3(
                scalars[a:b], device_bases=_db_slice(device_bases, a, b),
                window=window, max_bits=max_bits,
            ))
        return acc
    dev = device_bases.x.device
    window = _effective_window(window, device_bases.x)
    W = _windows_for(window, curve.scalar.p, max_bits)
    n_pad = max(512, _next_pow2(n))
    if max_bits is None:
        sabs, negs_n = _sym_reduce_host(scalars, curve.scalar.p)
    else:
        sabs, negs_n = list(scalars), np.zeros(n, dtype=bool)
    negs = np.zeros(n_pad, dtype=bool)
    negs[:n] = negs_n
    ulimbs = torch.from_numpy(_scalar_ulimbs(sabs, n_pad, window, W)).to(dev)
    d = offset_digits_device(
        ulimbs, window, W, torch.from_numpy(negs).to(dev)
    ).reshape(W * n_pad)
    fx, fy, fyneg, finf = _windowed(device_bases, window, n_pad, W)
    sorted_d, st = _sortpack(d, fx, fy, fyneg, finf)
    out = _msm3_collect(_msm3_dispatch(TField(curve.base), sorted_d, st, window))
    return _xyzz_row_to_affine(curve, out)
