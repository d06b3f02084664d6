"""Fixed-base MSM by column-serial segmented accumulation (port of
``nova_tpu/ops/msm3.py``).

  1. signed c-bit digits over the joint fixed-base window space (window-
     shifted bases fold the 2^(c*w) weight into the base, so all windows
     share one bucket space; see msm2._precompute_shifted). Scalars are
     reduced to the symmetric range |s'| <= (p-1)/2 with the sign folded
     into the digits, so 255-bit scalars need W = 16 windows at c = 16.
  2. ONE stable ``torch.sort`` of the W*n |digit| keys (``_sortpack``).
     Nothing is gathered: the sorted positions are laid on an (R, C) grid
     column by column (column j holds positions j*R .. j*R + R-1), and K4
     reads each cell's base row through the sort permutation.
  3. kernel K4 (``accum``): one thread per column walks its R rows;
     acc += P (10-mul mixed add) while the digit repeats; where it
     changes, the ended run's total is written to its bucket's row of a
     tail table (one writer per row: a bucket's run ends once), and acc
     restarts at P. A run that reaches the column end is the column's
     carry.
  4. bucket totals (``_bucket_totals``): the C column-end carries
     (non-decreasing digits) go through the suffix pass K2s (C <= 256) or
     through K4 again (level 2, XYZZ input, complete adds, its own tail
     table) and K2s over the level-2 carries; K2s writes each run's total to
     its bucket's row, and each bucket's total is its tail plus its carry
     sums.
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

from nova_tpu_torch import _build, profiling
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


def _cell_points(pts: dict, rows, signs):
    """The int64 limb points of the cells whose point rows are `rows`: affine
    (x, y with y taken from yneg where signs[rows] < 0) or XYZZ."""
    x, y = pts["x"][rows].long(), pts["y"][rows].long()
    if "zz" in pts:
        return x, y, pts["zz"][rows].long(), pts["zzz"][rows].long()
    neg = (signs[rows] < 0)[..., None]
    return x, torch.where(neg, pts["yneg"][rows].long(), y)


def accum_plain(tf: TField, grid, digits, pts: dict, mode: str, nb: int,
                src=None, signs=None):
    """Plain K4: msm3._accum_xla over the cells of a sorted sequence, with
    the run tails written into a bucket table instead of a dense flush.

    The R*C cells lie on an (R, C) grid column by column (column j holds
    positions j*R .. j*R + R-1); cell p has the |digit| digits[p]
    (non-decreasing; `digits` may be a strided view) and the point at row
    src[p] of `pts` (row p without `src`). pts holds affine rows {"x", "y",
    "yneg"}, y read from yneg where signs[row] < 0, or XYZZ rows {"x", "y",
    "zz", "zzz"}. Each column is walked down its rows: acc += P while the
    digit repeats; where it changes, the ended run's total goes to row
    d - 1 of the tail table when its digit d > 0. Digit 0 is inert (no
    point, the identity). Modes "fast" (mixed or fast adds, bad & ~boundary
    flagged per column) and "complete".

    Returns (tails: dict of (nb, 16) int32, zero where no run ends inside a
    column; colend: dict of (C, 16), each column's final acc; flag (C,))."""
    R, C = grid
    dev = digits.device
    o = tf.ops(dev)
    pos = torch.arange(R * C, device=dev).view(C, R).t()  # (R, C) positions
    d_grid = digits[pos]
    rows = pos if src is None else src[pos]
    xyzz = "zz" in pts
    one = o.r.expand(C, NUM_LIMBS)
    zero = torch.zeros((C, NUM_LIMBS), dtype=_I64, device=dev)
    acc = (zero, zero, zero, zero)
    tails = [torch.zeros((nb + 1, NUM_LIMBS), dtype=_I64, device=dev) for _ in KEYS]
    prev = torch.full((C,), -1, dtype=d_grid.dtype, device=dev)
    bad_any = torch.zeros((C,), dtype=torch.bool, device=dev)
    for i in range(R):
        d = d_grid[i]
        live = d != 0
        boundary = d != prev
        # the run that ended here: row prev - 1 (row nb is a sink, dropped)
        tail = torch.where(boundary & (prev > 0), prev.long() - 1, nb)
        for t, a in zip(tails, acc):
            t[tail] = a
        q = _cell_points(pts, rows[i], signs)
        if not xyzz:
            z = torch.where(live[:, None], one, 0)
            q = q + (z, z)
        if mode == "fast":
            if xyzz:
                s, bad = xyzz_add_limbs_fast(o, acc, q)
            else:
                s, bad = _madd_fast(o, acc, q[0], q[1], live)
            bad_any = bad_any | (bad & ~boundary & live)
        else:
            s = xyzz_add_limbs(o, acc, q)
        start = boundary[:, None]
        acc = tuple(
            torch.where(live[:, None], torch.where(start, qc, sc), torch.where(start, 0, ac))
            for qc, sc, ac in zip(q, s, acc)
        )
        prev = d
    return (
        {k: t[:nb].to(_I32) for k, t in zip(KEYS, tails)},
        _from_limbs(acc), bad_any.to(_I32),
    )


def accum(tf: TField, grid, digits, pts: dict, mode: str, nb: int,
          src=None, signs=None):
    """K4: segmented accumulation down the columns of the (R, C) grid of a
    sorted sequence, with the base rows read by index and the run tails
    written to an (nb, 16) table; see accum_plain for the contract."""
    assert mode in ("fast", "complete"), mode
    keys = KEYS if "zz" in pts else ("x", "y", "yneg")
    ins = [digits] + [pts[k] for k in keys]
    ins += [t for t in (src, signs) if t is not None]
    if not on_cuda(*ins):
        return accum_plain(tf, grid, digits, pts, mode, nb, src, signs)
    R, C = grid
    affine = len(keys) == 3
    if affine and (src is None or signs is None):
        raise ValueError("affine K4 input is read by index: src and signs are needed")
    if digits.dtype != _I32 or digits.dim() != 1 or digits.shape[0] < R * C:
        raise ValueError("digits: (R*C,) int32, contiguous or strided")
    if src is not None and (src.dtype != _I64 or not src.is_contiguous()):
        raise ValueError("src: contiguous int64 positions")
    coords = check_i32(*(pts[k] for k in keys))
    signs = None if signs is None else check_i32(signs)[0]
    tails = coords[0].new_zeros((4, nb, NUM_LIMBS))
    colend = coords[0].new_empty((4, C, NUM_LIMBS))
    flag = torch.empty((C,), dtype=_I32, device=digits.device)
    p4 = coords[3] if len(coords) == 4 else coords[2]  # unused with affine input
    with torch.cuda.device(digits.device):
        err = _build.lib().nt_accum(
            int(affine), int(mode == "fast"), digits.data_ptr(), digits.stride(0),
            0 if src is None else src.data_ptr(),
            0 if signs is None else signs.data_ptr(),
            *(t.data_ptr() for t in coords[:3]), p4.data_ptr(),
            *(tails[i].data_ptr() for i in range(4)), nb,
            *(colend[i].data_ptr() for i in range(4)), flag.data_ptr(), R, C,
            tf.consts_ptr, _build.stream_of(digits),
        )
        _build.check(err, "accum")
        _build.LAUNCHES["accum"] += 1
    return dict(zip(KEYS, tails)), dict(zip(KEYS, colend)), flag


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


def _sortpack(d, fx, fy, fyneg, finf):
    """Signed digits and window-shifted bases -> (sorted_d (n_s,) int32
    ascending |digits|, st), where st = {"grid": (R, C), "src": the sort
    permutation (n_s,) int64, "signs": d, "pts": {"x", "y", "yneg"}} is
    what K4 reads: cell p's base is row src[p], with y from yneg where
    signs[src[p]] < 0. Infinity bases get digit 0 (inert). Nothing is
    gathered here: K4 reads the base rows by index."""
    absd = torch.where(finf, 0, d.abs())
    sorted_d, sidx = torch.sort(absd, stable=True)
    st = {"grid": _grid_shape(d.shape[0]), "src": sidx, "signs": d,
          "pts": {"x": fx, "y": fy, "yneg": fyneg}}
    return sorted_d, st


# ---------------------------------------------------------------------------
# kernel K2s: the suffix pass of the bucket totals
# ---------------------------------------------------------------------------

_SUF_SLICES = 256  # K2s threads: each owns m / 256 consecutive carries


def _suffix_slices(m: int) -> int:
    assert m >= 1 and m & (m - 1) == 0, m
    return min(m, _SUF_SLICES)


def _run_table(tables, writes, nb: int):
    """Write each (digit, point, mask) run total to row d - 1 (rows only
    for 1 <= d <= nb; the rest land in a dropped sink row)."""
    for d, pt, mask in writes:
        rows = torch.where(mask & (d >= 1) & (d <= nb), d.long() - 1, nb)
        for t, c in zip(tables, pt):
            t[rows] = c


def suffix_to_buckets_plain(tf: TField, digs, vals: dict, nb: int) -> dict:
    """Plain K2s: the total of each run of equal digits of `digs` ((m,)
    int32, m a power of two, each positive digit in one contiguous run; 0
    and -1 are inert) over the XYZZ rows `vals`, at row d - 1 of an (nb, 16)
    table, zero elsewhere. The kernel's order of adds: S = min(m, 256)
    slices of E = m / S rows; each slice is walked backwards (acc = v[p] +
    acc while the digit repeats), keeping its first run's partial HC and its
    last run's TC; a segmented Hillis-Steele suffix scan of HC over the
    slices (slice s links to s + 1 when it is one run that the next slice
    continues) joins runs that span slices, and the slice where such a run
    starts adds TC + the next slice's scan value."""
    o = tf.ops(digs.device)
    digs = digs.contiguous()
    m = digs.shape[0]
    S = _suffix_slices(m)
    E = m // S
    D = digs.view(S, E)
    V = tuple(v.view(S, E, NUM_LIMBS) for v in _as_limbs(vals))
    tables = [torch.zeros((nb + 1, NUM_LIMBS), dtype=_I64, device=digs.device)
              for _ in KEYS]
    writes = []
    acc = tuple(v[:, E - 1] for v in V)
    drun = D[:, E - 1]
    multi = torch.zeros((S,), dtype=torch.bool, device=digs.device)
    TC, td = acc, drun
    for p in range(E - 2, -1, -1):
        d = D[:, p]
        vp = tuple(v[:, p] for v in V)
        same = d == drun
        first = ~same & ~multi
        TC = tuple(torch.where(first[:, None], a, t) for a, t in zip(acc, TC))
        td = torch.where(first, drun, td)
        writes.append((drun, acc, ~same & multi))  # a run inside the slice
        multi = multi | ~same
        added = xyzz_add_limbs(o, vp, acc)
        acc = tuple(torch.where(same[:, None], a, v) for a, v in zip(added, vp))
        drun = d
    hd = drun
    TC = tuple(torch.where(multi[:, None], t, a) for t, a in zip(TC, acc))
    td = torch.where(multi, td, hd)
    prev = torch.cat([digs.new_full((1,), -2), digs[E - 1 : m - 1 : E]])
    starts = prev != hd
    nxt = torch.cat([digs[E::E], digs.new_full((1,), -2)])
    link = (nxt == td) & (torch.arange(S, device=digs.device) < S - 1)
    writes.append((hd, acc, multi & starts))  # a first run inside the slice
    # segmented suffix scan over the slices
    val, f = acc, multi | ~link
    off = 1
    while off < S:
        has = torch.arange(S, device=digs.device) + off < S
        w = tuple(torch.cat([v[off:], v[:off] * 0]) for v in val)
        g = torch.cat([f[off:], f.new_ones((off,))])
        added = xyzz_add_limbs(o, val, w)
        val = tuple(torch.where((has & ~f)[:, None], a, v) for a, v in zip(added, val))
        f = f | (g & has)
        off *= 2
    writes.append((hd, val, ~multi & starts))  # a run that starts in a one-run slice
    nval = tuple(torch.cat([v[1:], v[:1] * 0]) for v in val)
    joined = xyzz_add_limbs(o, TC, nval)
    last = tuple(torch.where(link[:, None], j, t) for j, t in zip(joined, TC))
    writes.append((td, last, multi))  # the last run of a slice of several
    _run_table(tables, writes, nb)
    return {k: t[:nb].to(_I32) for k, t in zip(KEYS, tables)}


def suffix_to_buckets(tf: TField, digs, vals: dict, nb: int) -> dict:
    """K2s: the run totals of `vals` grouped by the digits `digs`, at row
    d - 1 of a zeroed (nb, 16) table, in one launch; see
    suffix_to_buckets_plain for the contract."""
    ins = [vals[k] for k in KEYS]
    if not on_cuda(digs, *ins):
        return suffix_to_buckets_plain(tf, digs, vals, nb)
    m = int(digs.shape[0])
    E = m // _suffix_slices(m)
    if digs.dtype != _I32:
        raise ValueError("digits: int32")
    digs = digs.contiguous()
    ins = check_i32(*ins)
    table = ins[0].new_zeros((4, nb, NUM_LIMBS))
    with torch.cuda.device(digs.device):
        err = _build.lib().nt_suffix_buckets(
            digs.data_ptr(), *(t.data_ptr() for t in ins), m, E,
            *(table[i].data_ptr() for i in range(4)), nb, tf.consts_ptr,
            _build.stream_of(digs),
        )
        _build.check(err, "suffix_segmented")
        _build.LAUNCHES["suffix_segmented"] += 1
    return dict(zip(KEYS, table))


def _column_ends(seq, R: int):
    """The last digit of each column of `seq` on an (R, len/R) grid laid
    column by column: a strided view, no copy."""
    return seq.view(-1, R)[:, R - 1]


def _bucket_totals(tf: TField, sorted_d, tail1: dict, colend: dict, grid, nb: int):
    """Per-bucket totals (dict of (nb, 16) XYZZ rows) from K4's level-1 tail
    table and column-end carries, fixing up runs that span columns: the C
    carries (non-decreasing digits) go through the suffix pass K2s (C <=
    256), or through K4 again (level 2: XYZZ input, complete adds, its own
    tail table) and K2s over the level-2 carries; each bucket's total is its
    tail plus its carry sums."""
    R, C = grid
    if C <= 256:  # C is a power of two: one suffix pass finishes it
        sums = suffix_to_buckets(tf, _column_ends(sorted_d, R), colend, nb)
        return xyzz_add(tf, tail1, sums)

    # level 2: the C carries on an (R2, C2) grid through K4 (complete adds)
    C2 = max(128, C // _R2)
    R2 = C // C2
    tail2, colend2, _ = accum(tf, (R2, C2), _column_ends(sorted_d, R), colend,
                              "complete", nb)
    # level 3: the suffix pass over the C2 level-2 carries
    sums3 = suffix_to_buckets(tf, _column_ends(sorted_d, R * R2), colend2, nb)
    return xyzz_add(tf, xyzz_add(tf, tail1, tail2), sums3)


def _msm3_dispatch(bf: TField, sorted_d, st, c: int):
    """Queue accumulate + finish without waiting for the device; returns a
    handle for _msm3_collect (lets a batch queue every MSM first)."""
    with profiling.phase("msm.dispatch"):
        out, flag = _msm3_finish(bf, sorted_d, st, c, "fast")
    return (bf, sorted_d, st, c, out, flag)


def _msm3_sum(bf: TField, sorted_d, st, c: int, mode: str):
    """Accumulate (K4), bucket totals (K2s, K2) and the weighted reduction
    (K5) of a sorted sequence: the MSM as (1, 16) Montgomery XYZZ rows, and
    K4's per-column degenerate-add flags."""
    nb = 1 << (c - 1)
    tail1, colend, flag = accum(bf, st["grid"], sorted_d, st["pts"], mode, nb,
                                st["src"], st["signs"])
    totals = _bucket_totals(bf, sorted_d, tail1, colend, st["grid"], nb)
    return _bucket_reduce(bf, totals), flag


def _msm3_finish(bf: TField, sorted_d, st, c: int, mode: str):
    s, flag = _msm3_sum(bf, sorted_d, st, c, mode)
    return {k: bf.from_mont(v) for k, v in s.items()}, flag.any()


def _msm3_collect(pending):
    """Wait for a dispatched MSM; rerun K4 in complete mode (reusing the
    sort) when a degenerate fast add was flagged."""
    bf, sorted_d, st, c, out, flag = pending
    profiling.count("msm.calls")
    with profiling.phase("msm.read"):
        if bool(flag.item()):
            profiling.count("msm.reruns")
            with profiling.phase("msm.rerun"):
                out, _ = _msm3_finish(bf, sorted_d, st, c, "complete")
        return {k: v.cpu() for k, v in out.items()}


def _prep_mont(db: DeviceBases2, marr, c: int, W: int):
    """(n, 16) Montgomery scalars -> padded (sorted_d, st)."""
    with profiling.phase("msm.prep"):
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
    """The window to use: 2..17 (at most 2^16 buckets); on CPU
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
