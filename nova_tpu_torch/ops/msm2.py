"""Signed-digit Pippenger MSM of host int scalars (port of
``nova_tpu/ops/msm2.py``), plus the pieces the fixed-base MSM (msm3)
shares: marshalled bases and their window-shifted precompute and the
weighted bucket reduction (kernel K5).

``msm_device2`` (the commit of a plain int list):

  1. signed c-bit digits of the scalars (``signed_digits_device``);
  2. per window space: a stable sort by |digit|, segment ranks, then a
     cascade of combine STAGES (``_plan``), each kernel B6 (``stage``)
     running <= 4 Brent-Kung rounds in which the rank-r lane of a digit
     run absorbs lane r + 2^k (``_round_masks``), with the survivors
     compacted between stages (``_compact``);
  3. the segment heads scattered into a table of 2^(c-1) buckets and the
     weighted bucket reduction (K5, one launch: a pairwise tree of bit-sums
     and its Horner finish inside the kernel).

With a reused key (``reuse=True``) the window-shifted bases fold every
window into ONE joint space; otherwise each window runs on its own and the
host finishes with Horner. The fixed-base path runs the fast formulas and
reruns with complete adds when a degenerate add was flagged.

Not ported: the TPU's chunk-major packing and the 256-lane overlap pad of
``_stage``, which exist only for the TPU's DMAs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nova_tpu_torch import _build
from nova_tpu_torch._device import on_cuda, resolve
from nova_tpu_torch.curves.points import xyzz_double
from nova_tpu_torch.fields import kernels
from nova_tpu_torch.fields.kernels import (
    affine_add_limbs_fast,
    check_i32,
    xyzz_add_limbs,
    xyzz_add_limbs_fast,
    xyzz_double_limbs,
)
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField

KEYS = kernels.KEYS
_I32 = torch.int32
PAD = 256  # smallest stage width
MAX_STAGE_ROUNDS = 4  # rounds per stage: B6's halo covers 2^4 - 1 lanes
STAGE_MODES = ("complete", "fast", "fast0")


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _as_limbs(pts: dict):
    return tuple(pts[k].long() for k in KEYS)


def _from_limbs(coords) -> dict:
    return {k: v.to(_I32) for k, v in zip(KEYS, coords)}


# ---------------------------------------------------------------------------
# weighted bucket reduction: sum_i (i+1) * T[i]  (kernel K5)
# ---------------------------------------------------------------------------

_PAIRS = 256  # pair threads per K5 block: a block takes 2 * _PAIRS buckets
_SLOTS = 32  # width of K5's last pairwise sum (log2(nb) + 1 <= 32 values)


def _pairs_add(o, X):
    """Complete adds of neighbouring rows, (..., A, 2n, 16) -> (..., A, n, 16)."""
    return xyzz_add_limbs(o, tuple(v[..., 0::2, :] for v in X),
                          tuple(v[..., 1::2, :] for v in X))


def _bit_sum_tree(o, X, levels: int):
    """`levels` levels of K5's pairwise tree over (..., 1, nb, 16) int64 rows
    X (a tuple of four): returns (..., 1 + levels, nb >> levels, 16) arrays
    [R, V_0, .., V_(levels-1)], where R[j] sums the 2^levels rows of node j
    and V_k[j] those of its rows whose index has bit k."""
    for _ in range(levels):
        S = _pairs_add(o, X)
        X = tuple(torch.cat([s, v[..., :1, 1::2, :]], dim=-3) for s, v in zip(S, X))
    return X


def bucket_reduce_plain(tf: TField, table: dict) -> dict:
    """Plain K5: sum_i (i+1) T[i] over an (nb, 16) XYZZ table, nb = 2^n, as
    sum_i T[i] + sum_k 2^k V_k with V_k the sum of the T[i] whose index has
    bit k, in the kernel's order of adds: n levels of a pairwise tree whose
    nodes carry their sum R and the partial bit-sums [R, V_0, .., V_(l-1)]
    (each level adds neighbouring pairs of every array and appends the
    right-hand node sums as V_l); then V_k doubled k times and the values
    [R, V_0, 2 V_1, ..] plus zero rows added pairwise over _SLOTS slots.
    Returns (1, 16) coordinates; a batch of tables, (B, nb, 16), gives
    (B, 1, 16) in the same number of steps."""
    o = tf.ops(table["x"].device)
    nb = table["x"].shape[-2]
    n = nb.bit_length() - 1
    assert nb == 1 << n and n >= 1, nb
    X = _bit_sum_tree(o, tuple(v.unsqueeze(-3) for v in _as_limbs(table)), n)
    V = tuple(v[..., 1:, 0, :] for v in X)  # (..., n, 16): V_0 .. V_(n-1)
    for d in range(1, n):
        V = tuple(torch.cat([a, b], dim=-2) for a, b in zip(
            tuple(v[..., :d, :] for v in V),
            xyzz_double_limbs(o, tuple(v[..., d:, :] for v in V))))
    pad = X[0].new_zeros(X[0].shape[:-3] + (_SLOTS - n - 1, NUM_LIMBS))
    Y = tuple(torch.cat([x[..., :1, 0, :], v, pad], dim=-2).unsqueeze(-3)
              for x, v in zip(X, V))
    while Y[0].shape[-2] > 1:
        Y = _pairs_add(o, Y)
    return _from_limbs(tuple(v[..., 0, :, :] for v in Y))


def _bucket_reduce(tf: TField, table: dict) -> dict:
    """K5: sum_i (i+1) T[i] over an (nb, 16) XYZZ table, nb a power of two,
    as (1, 16) XYZZ coordinates, in one launch (see bucket_reduce_plain for
    the order of adds)."""
    ins = [table[k] for k in KEYS]
    nb = ins[0].shape[0]
    n = nb.bit_length() - 1
    assert nb == 1 << n and n >= 1, nb
    if not on_cuda(*ins):
        return bucket_reduce_plain(tf, table)
    ins = check_i32(*ins)
    P = min(_PAIRS, nb // 2)
    logp = P.bit_length() - 1
    blocks = nb // (2 * P)
    scratch = ins[0].new_empty((2 * (logp + 2) * blocks, 32))  # Pt: 32 words
    counter = torch.zeros((1,), dtype=_I32, device=ins[0].device)
    out = {k: ins[0].new_empty((1, NUM_LIMBS)) for k in KEYS}
    with torch.cuda.device(ins[0].device):
        err = _build.lib().nt_bucket_reduce(
            *(t.data_ptr() for t in ins), *(out[k].data_ptr() for k in KEYS),
            scratch.data_ptr(), counter.data_ptr(), n, logp, tf.consts_ptr,
            _build.stream_of(ins[0]),
        )
        _build.check(err, "bucket_reduce")
        _build.LAUNCHES["bucket_reduce"] += 1
    return out


# ---------------------------------------------------------------------------
# bases: marshalling and the window-shifted precompute
# ---------------------------------------------------------------------------


def _negate_y(tf: TField, y):
    """p - y on (n, 16) rows, keeping y == 0 at 0."""
    o = tf.ops(y.device)
    res = o.sub(o.p.expand(y.shape), y.long()).to(_I32)
    return torch.where(tf.is_zero(y)[:, None], y, res)


def _precompute_shifted(tf: TField, c: int, W: int, bx, by, binf):
    """Affine shifted bases for the fixed-base MSM: window w holds
    2^(c*w) * B_i for every base. Returns (W*n, 16) x/y rows (Montgomery)
    and (W*n,) inf flags: per window one K3 launch of c chained doublings,
    then one batched inversion over [zz; zzz] (K1). Run once per (key,
    size) and cached."""
    n = bx.shape[0]
    one = tf.one_mont(bx)
    zz0 = torch.where(binf[:, None], torch.zeros_like(bx), one)
    pts = {"x": bx, "y": by, "zz": zz0, "zzz": zz0}
    xs, ys, infs = [bx], [by], [binf]
    for _ in range(W - 1):
        pts = xyzz_double(tf, pts, c)
        both = torch.cat([pts["zz"], pts["zzz"]], dim=0)
        pad = _next_pow2(both.shape[0]) - both.shape[0]
        if pad:
            both = torch.cat([both, one[:1].expand(pad, NUM_LIMBS)], dim=0)
        inv = tf.batch_inv_tree(both)
        xs.append(tf.mont_mul(pts["x"], inv[:n]))
        ys.append(tf.mont_mul(pts["y"], inv[n : 2 * n]))
        infs.append(tf.is_zero(pts["zz"]))
    return torch.cat(xs), torch.cat(ys), torch.cat(infs)


class DeviceBases2:
    """Affine bases marshalled once: x, y (N, 16) Montgomery int32 + inf
    (N,) bool, on `device` (CUDA unless given)."""

    def __init__(self, curve, points, device=None):
        self.curve = curve
        self.tf = TField(curve.base)
        dev = resolve(device)
        self.device = dev
        if points is not None:
            tf = self.tf
            xs = torch.from_numpy(tf.pack([p.x for p in points])).to(dev)
            ys = torch.from_numpy(tf.pack([p.y for p in points])).to(dev)
            self.x = tf.to_mont(xs)
            self.y = tf.to_mont(ys)
            self.inf = torch.tensor(
                [p.infinity for p in points], dtype=torch.bool, device=dev
            )
            self.n = len(points)
        self._fixed = {}  # (c, n_pad) -> (fx, fy, fyneg, finf)
        # (c, n_pad, mesh devices) -> each shard's block of _fixed (parallel)
        self._shards = {}

    @classmethod
    def from_tensors(cls, curve, x, y, inf) -> "DeviceBases2":
        """Wrap already-marshalled (N, 16) Montgomery rows and (N,) flags."""
        db = cls(curve, None, device=x.device)
        db.x, db.y, db.inf = x, y, inf
        db.n = int(x.shape[0])
        return db

    def fixed(self, c: int, n_pad: int):
        """(fx, fy, fyneg, finf): window-shifted bases over all
        (255 + c - 1)//c + 1 windows, rows of window w at [w*n_pad,
        (w+1)*n_pad); cached per (window, size)."""
        key = (c, n_pad)
        if key not in self._fixed:
            bx, by, binf = _sized(self, n_pad)
            fx, fy, finf = _precompute_shifted(self.tf, c, _num_windows2(c), bx, by, binf)
            self.set_fixed(c, n_pad, fx, fy, finf)
        return self._fixed[key]

    def set_fixed(self, c: int, n_pad: int, fx, fy, finf) -> None:
        """Install a precompute computed elsewhere (see interop)."""
        self._fixed[(c, n_pad)] = (fx, fy, _negate_y(self.tf, fy), finf)
        for k in [k for k in self._shards if k[:2] == (c, n_pad)]:
            del self._shards[k]


def _sized(device_bases: DeviceBases2, n_pad: int):
    """Base arrays padded/truncated to n_pad lanes (pad lanes -> inf)."""
    bx, by, binf = device_bases.x, device_bases.y, device_bases.inf
    if device_bases.n < n_pad:
        padn = n_pad - device_bases.n
        bx = torch.cat([bx, bx.new_zeros((padn, NUM_LIMBS))])
        by = torch.cat([by, by.new_zeros((padn, NUM_LIMBS))])
        binf = torch.cat([binf, binf.new_ones((padn,))])
    elif device_bases.n > n_pad:
        bx, by, binf = bx[:n_pad], by[:n_pad], binf[:n_pad]
    return bx, by, binf


def _row_to_int(row) -> int:
    a = np.asarray(row.cpu() if isinstance(row, torch.Tensor) else row)
    return int.from_bytes(a.reshape(-1).astype("<u2").tobytes(), "little")


def _xyzz_row_to_affine(curve, wins):
    """Standard-form XYZZ (1, 16) rows -> host AffinePoint."""
    from nova_tpu_torch.curves.spec import AffinePoint

    f = curve.base
    zz = _row_to_int(wins["zz"])
    if zz == 0:
        return AffinePoint.identity(curve)
    x = _row_to_int(wins["x"])
    y = _row_to_int(wins["y"])
    zzz = _row_to_int(wins["zzz"])
    return AffinePoint(curve, f.mul(x, f.inv(zz)), f.mul(y, f.inv(zzz)))


# ---------------------------------------------------------------------------
# kernel B6: one combine stage
# ---------------------------------------------------------------------------


def _stage_input(tf: TField, pts: dict, live):
    """The stage's input as int64 limb tuples: with `live`, x/y affine and
    zz = zzz = the Montgomery one on live lanes, 0 elsewhere."""
    x, y = pts["x"].long(), pts["y"].long()
    if live is None:
        return (x, y, pts["zz"].long(), pts["zzz"].long())
    z = torch.where(live[:, None], tf.ops(x.device).one(x), 0)
    return (x, y, z, z)


def stage_plain(tf: TField, rounds: int, masks, pts: dict,
                mode: str = "complete", live=None, block: int = 1 << 18):
    """Plain B6 (msm2._stage semantics). masks: (rounds, n) int32; pts:
    dict of (n, 16) int32 rows, x/y only when `live` (an (n,) bool of
    non-inert lanes) is given. In round r lane i absorbs lane i + 2^r where
    masks[r, i] is set; partners past n are the identity (all zeros).
    Returns (dict of (n, 16) int32 XYZZ rows, flag: a bool tensor, the OR
    of `bad` over active lanes in the fast modes).

    Lanes run in blocks of `block` plus a halo of 2^rounds - 1 lanes, which
    bounds the memory of the int64 temporaries; a block's own lanes end
    with the same values as in one pass over all n lanes."""
    assert mode in STAGE_MODES, mode
    o = tf.ops(pts["x"].device)
    n = pts["x"].shape[0]
    halo = (1 << rounds) - 1
    P_all = _stage_input(tf, pts, live)
    outs = []
    flag = torch.zeros((), dtype=torch.bool, device=pts["x"].device)
    for a in range(0, n, block):
        b = min(n, a + block)
        e = min(n, b + halo)
        P = tuple(v[a:e] for v in P_all)
        L = e - a
        for r in range(rounds):
            s = min(1 << r, L)
            Q = tuple(torch.cat([v[s:], v.new_zeros((s, NUM_LIMBS))]) for v in P)
            # only the active lanes change: add just those
            act = torch.nonzero(masks[r, a:e] != 0).squeeze(1)
            Pa = tuple(v[act] for v in P)
            Qa = tuple(v[act] for v in Q)
            bad = None
            if mode == "complete":
                S = xyzz_add_limbs(o, Pa, Qa)
            elif mode == "fast0" and r == 0:
                S, bad = affine_add_limbs_fast(o, Pa, Qa)
            else:
                S, bad = xyzz_add_limbs_fast(o, Pa, Qa)
            if bad is not None:
                flag = flag | bad[act < b - a].any()
            P = tuple(pv.index_copy(0, act, sv) for sv, pv in zip(S, P))
        outs.append(tuple(v[: b - a] for v in P))
    return {k: torch.cat([t[c] for t in outs]).to(_I32) for c, k in enumerate(KEYS)}, flag


def stage(tf: TField, rounds: int, masks, pts: dict, mode: str = "complete",
          live=None):
    """B6: one combine stage; see stage_plain for the contract. On CUDA
    tensors the kernel runs (nova_tpu_torch/csrc/stage_kernel.cu) and the
    flag comes back as a (1,) int32 tensor on the card, unread."""
    assert mode in STAGE_MODES, mode
    assert 1 <= rounds <= MAX_STAGE_ROUNDS, rounds
    keys = KEYS[:2] if live is not None else KEYS
    ins = [pts[k] for k in keys] + [masks] + ([live] if live is not None else [])
    if not on_cuda(*ins):
        return stage_plain(tf, rounds, masks, pts, mode, live)
    n = int(pts["x"].shape[0])
    assert masks.shape == (rounds, n), (masks.shape, rounds, n)
    coords = check_i32(*(pts[k] for k in keys))
    masks = check_i32(masks)[0]
    if live is not None:
        live = check_i32(live.to(_I32))[0]
        coords = coords + coords  # zz/zzz pointers unused with affine input
    else:
        live = masks  # pointer unused
    out = {k: coords[0].new_empty((n, NUM_LIMBS)) for k in KEYS}
    flag = torch.zeros((1,), dtype=_I32, device=masks.device)
    with torch.cuda.device(masks.device):
        err = _build.lib().nt_stage(
            STAGE_MODES.index(mode), int(len(keys) == 2),
            *(t.data_ptr() for t in coords), live.data_ptr(), masks.data_ptr(),
            *(out[k].data_ptr() for k in KEYS), flag.data_ptr(), n, rounds,
            tf.consts_ptr, _build.stream_of(masks),
        )
        _build.check(err, "stage")
        _build.LAUNCHES["stage"] += 1
    return out, flag


# ---------------------------------------------------------------------------
# digits, masks, the stage plan, compaction
# ---------------------------------------------------------------------------


def signed_digits_device(limbs16, c: int, num_windows: int):
    """(N, 16) 16-bit scalar limbs -> (W, N) int32 signed digits with
    scalar = sum_w d_w * 2^(c*w), d_w in [-2^(c-1), 2^(c-1)]."""
    n = limbs16.shape[0]
    u = limbs16.long()
    mask = (1 << c) - 1
    half, full = 1 << (c - 1), 1 << c
    out = []
    carry = torch.zeros((n,), dtype=torch.int64, device=u.device)
    for w in range(num_windows):
        li, ofs = divmod(w * c, 16)
        if li >= 16:
            d = torch.zeros((n,), dtype=torch.int64, device=u.device)
        else:
            d = u[:, li] >> ofs
            have = 16 - ofs
            j = li + 1
            while have < c and j < 16:
                d = d | (u[:, j] << have)
                have += 16
                j += 1
        d = (d & mask) + carry
        hi = d > half  # keep +half as a positive digit (top bucket)
        out.append(torch.where(hi, d - full, d))
        carry = hi.long()
    return torch.stack(out).to(_I32)


def _round_masks(ds, rank, rounds: int):
    """(rounds, n) int32 Brent-Kung masks: at round r, lane i absorbs
    i + 2^r when both share a nonzero digit and rank(i) % 2^(r+1) == 0."""
    n = ds.shape[0]
    idx = torch.arange(n, device=ds.device)
    masks = []
    for r in range(rounds):
        s = 1 << r
        pd = torch.cat([ds[s:], ds.new_full((min(s, n),), -1)])
        same = (pd == ds) & (ds != 0) & ((idx + s) < n)
        aligned = (rank & ((s << 1) - 1)) == 0
        masks.append(same & aligned)
    return torch.stack(masks).to(_I32)


def _plan(n: int, nb: int, rounds_per_stage: int = MAX_STAGE_ROUNDS):
    """Stage plan: list of (rounds, width_in, width_out) covering
    ceil(log2(n)) rounds, so any distribution of digits merges fully.
    Survivors of a stage over width w: at most one per nonzero digit run
    (<= nb) plus one per 2^r lanes; widths are powers of two >= PAD."""
    stages = []
    width = n
    merged = 0
    need = max(1, int(np.ceil(np.log2(max(2, n)))))
    while merged < need:
        r = min(rounds_per_stage, need - merged)
        merged += r
        width_out = min(n, max(PAD, _next_pow2(nb + (width >> r) + 1)))
        if merged >= need:
            width_out = min(n, max(PAD, _next_pow2(nb)))
        stages.append((r, width, width_out))
        width = width_out
    return stages


def _compact(keep, size_out: int, ds, rank, pts: dict):
    """Stable-compact the lanes where keep is set into `size_out` lanes
    (a stable sort of the dead flag, then gathers). Lanes past the
    survivor count get digit 0, so they stay inert."""
    _, src = torch.sort((~keep).to(_I32), stable=True)
    src = src[:size_out]
    live = torch.arange(size_out, device=keep.device) < keep.sum()
    ds2 = torch.where(live, ds[src], 0)
    rank2 = torch.where(live, rank[src], 0)
    return ds2, rank2, {k: pts[k][src] for k in KEYS}


# ---------------------------------------------------------------------------
# the MSM programs
# ---------------------------------------------------------------------------


def _segment_rank(ds):
    """Rank of each lane in its run of equal values of the sorted `ds`:
    its distance to the run's head, the first position of its value (the
    JAX package's idx - cummax(where(heads, idx, 0)); one binary search
    per lane instead of a scan)."""
    idx = torch.arange(ds.shape[0], device=ds.device)
    return idx - torch.searchsorted(ds, ds)


def _window_sum(tf: TField, absd, px, py, nb: int, mode: str = "complete"):
    """One window space. absd: (n,) int32 |digits| in [0, nb]; px/py:
    (n, 16) Montgomery affine rows with Y sign-adjusted; digit-0 lanes are
    inert. Returns ((1, 16) XYZZ rows of sum_b b * bucket_b, flag)."""
    n = absd.shape[0]
    dev = absd.device
    ds, order = torch.sort(absd, stable=True)
    pts = {"x": px[order], "y": py[order]}
    rank = _segment_rank(ds)
    live = ds != 0
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    for si, (rounds, _, w_out) in enumerate(_plan(n, nb)):
        masks = _round_masks(ds, rank, rounds)
        smode = mode if (mode != "fast0" or si == 0) else "fast"
        pts, f = stage(tf, rounds, masks, pts, smode, live=live)
        live = None  # affine inputs only on the first stage
        flag = flag | f.any()
        keep = ((rank & ((1 << rounds) - 1)) == 0) & (ds != 0)
        ds, rank, pts = _compact(keep, w_out, ds, rank >> rounds, pts)
    # every surviving lane with rank 0 is a whole bucket; the others land
    # in the spare row nb, which is dropped
    ids = torch.where((rank == 0) & (ds != 0), ds.long() - 1, nb)
    table = {}
    for k in KEYS:
        tab = pts[k].new_zeros((nb + 1, NUM_LIMBS))
        tab[ids] = pts[k]
        table[k] = tab[:nb]
    return _bucket_reduce(tf, table), flag


def _num_windows2(c: int) -> int:
    return (255 + c - 1) // c + 1  # +1 for the signed carry


def _msm2_fixed_program(tf: TField, c: int, limbs, fixed, mode: str):
    """Fixed-base MSM: ONE joint window space over W*n (point, digit)
    pairs of the window-shifted bases. Returns (standard-form (1, 16) XYZZ
    rows, flag)."""
    fx, fy, fyneg, finf = fixed
    W = _num_windows2(c)
    d = signed_digits_device(limbs, c, W).reshape(-1)
    absd = torch.where(finf, 0, d.abs())
    sy = torch.where((d < 0)[:, None], fyneg, fy)
    s, flag = _window_sum(tf, absd, fx, sy, 1 << (c - 1), mode)
    return {k: tf.from_mont(v) for k, v in s.items()}, flag


def _msm2_program(tf: TField, c: int, limbs, bx, by, binf):
    """General path: one window space per window (complete adds); returns
    standard-form (W, 16) XYZZ window sums."""
    nb = 1 << (c - 1)
    neg_by = _negate_y(tf, by)
    wins = []
    for d in signed_digits_device(limbs, c, _num_windows2(c)):
        absd = torch.where(binf, 0, d.abs())
        sy = torch.where((d < 0)[:, None], neg_by, by)
        s, _ = _window_sum(tf, absd, bx, sy, nb)
        wins.append(s)
    return {k: tf.from_mont(torch.cat([w[k] for w in wins])) for k in KEYS}


def _scalar_limbs(scalars, n_pad: int) -> np.ndarray:
    """(n_pad, 16) int32 16-bit limbs of the scalars; pad rows are 0."""
    limbs = np.zeros((n_pad, NUM_LIMBS), dtype=np.int32)
    if len(scalars):
        buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
        limbs[: len(scalars)] = np.frombuffer(buf, dtype="<u2").reshape(
            len(scalars), NUM_LIMBS
        )
    return limbs


def _window_for(n_pad: int) -> int:
    """Wider windows cut the W*n pair count; the bucket table stays minor."""
    if n_pad >= 1 << 18:
        return 16
    if n_pad >= 1 << 14:
        return 14
    return 12


def msm_device2(scalars: Sequence[int], bases=None,
                device_bases: Optional[DeviceBases2] = None,
                window: Optional[int] = None, reuse: bool = None, device=None):
    """MSM of host int scalars (each below 2^256) on the bases' device,
    with an exact host finish.

    With `device_bases` (or `reuse=True`) the FIXED-BASE path runs: the
    window-shifted bases are precomputed once per (key, size) so the MSM is
    one joint window space, with fast adds and a complete rerun when the
    flag (read once) is set. One-shot base sets (`bases=[...]`, marshalled
    on `device`) take the per-window general path and host Horner."""
    from nova_tpu_torch.curves.spec import AffinePoint

    n = len(scalars)
    if n == 0:
        raise ValueError("empty msm")
    if reuse is None:
        reuse = device_bases is not None
    if device_bases is None:
        device_bases = DeviceBases2(bases[0].curve, bases, device=device)
    curve = device_bases.curve
    tf = TField(curve.base)
    n_pad = max(512, _next_pow2(n))
    limbs = torch.from_numpy(_scalar_limbs(scalars, n_pad)).to(device_bases.x.device)
    if window is None:
        window = _window_for(n_pad)
    if not 2 <= window <= 17:
        raise ValueError(f"window must be in 2..17, got {window}")

    if reuse:
        fixed = device_bases.fixed(window, n_pad)
        out, flag = _msm2_fixed_program(tf, window, limbs, fixed, "fast0")
        if bool(flag.item()):
            # a degenerate (P = +-Q) fast add was flagged: rerun with the
            # complete formulas (never taken for distinct bases)
            out, _ = _msm2_fixed_program(tf, window, limbs, fixed, "complete")
        return _xyzz_row_to_affine(curve, {k: v.cpu() for k, v in out.items()})

    bx, by, binf = _sized(device_bases, n_pad)
    wins = {k: v.cpu() for k, v in _msm2_program(tf, window, limbs, bx, by, binf).items()}
    # Horner across windows on exact host ints: acc = 2^c * acc + win_w
    acc = AffinePoint.identity(curve)
    for w in reversed(range(wins["x"].shape[0])):
        if not acc.is_identity():
            acc = acc.mul(1 << window)
        pt = _xyzz_row_to_affine(curve, {k: v[w] for k, v in wins.items()})
        if not pt.is_identity():
            acc = acc.add(pt)
    return acc
