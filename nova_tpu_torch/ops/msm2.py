"""The part of ``nova_tpu/ops/msm2.py`` that the fixed-base MSM (msm3)
needs: marshalled bases and their window-shifted precompute, the limb
formulas, and the weighted bucket reduction (kernel K5).

The int-list route ``msm_device2`` and its stage kernel are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from nova_tpu_torch import _build
from nova_tpu_torch._device import on_cuda, resolve
from nova_tpu_torch.curves.points import xyzz_add, xyzz_double
from nova_tpu_torch.fields import kernels
from nova_tpu_torch.fields.kernels import check_i32, xyzz_add_limbs
from nova_tpu_torch.fields.spec import NUM_LIMBS
from nova_tpu_torch.fields.tfield import TField

KEYS = kernels.KEYS
_I32 = torch.int32


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _as_limbs(pts: dict):
    return tuple(pts[k].long() for k in KEYS)


def _from_limbs(coords) -> dict:
    return {k: v.to(_I32) for k, v in zip(KEYS, coords)}


# ---------------------------------------------------------------------------
# weighted bucket reduction: sum_i (i+1) * T[i]  (kernel K5)
# ---------------------------------------------------------------------------

_GROUP = 256  # buckets per K5 block (one thread each); nb <= _GROUP^2


def bucket_reduce_groups_plain(tf: TField, table: dict, m: int):
    """Plain K5: for each group g of m rows returns S_g = sum_j T[g*m+j]
    and W_g = sum_j (j+1) T[g*m+j] by two Hillis-Steele suffix passes
    (partner (j + 2^r) mod m, with ZZ read as zero when j + 2^r >= m)."""
    o = tf.ops(table["x"].device)
    nb = table["x"].shape[0]
    logm = int(np.log2(m))
    G = nb // m
    P = tuple(v.view(G, m, NUM_LIMBS) for v in _as_limbs(table))
    lane = torch.arange(m, device=table["x"].device)
    S = None
    for r2 in range(2 * logm):
        if r2 == logm:
            S = tuple(v[:, 0] for v in P)
        s = 1 << (r2 % logm)
        Q = [torch.roll(v, -s, dims=1) for v in P]
        Q[2] = torch.where((lane >= m - s)[None, :, None], 0, Q[2])
        P = xyzz_add_limbs(o, P, tuple(Q))
    W = tuple(v[:, 0] for v in P)
    return _from_limbs(S), _from_limbs(W)


def bucket_reduce_groups(tf: TField, table: dict, m: int):
    """K5: per-group (S, W) of an XYZZ table of nb = G*m rows; returns two
    dicts of (G, 16) int32 coordinates."""
    nb = table["x"].shape[0]
    assert 2 <= m <= _GROUP and m & (m - 1) == 0 and nb % m == 0, (nb, m)
    ins = [table[k] for k in KEYS]
    if not on_cuda(*ins):
        return bucket_reduce_groups_plain(tf, table, m)
    ins = check_i32(*ins)
    G = nb // m
    S = {k: ins[0].new_empty((G, NUM_LIMBS)) for k in KEYS}
    W = {k: ins[0].new_empty((G, NUM_LIMBS)) for k in KEYS}
    with torch.cuda.device(ins[0].device):
        err = _build.lib().nt_bucket_reduce(
            *(t.data_ptr() for t in ins), *(S[k].data_ptr() for k in KEYS),
            *(W[k].data_ptr() for k in KEYS), G, m, tf.consts_ptr,
            _build.stream_of(ins[0]),
        )
        _build.check(err, "bucket_reduce")
        _build.LAUNCHES["bucket_reduce"] += 1
    return S, W


def _bucket_reduce(tf: TField, table: dict) -> dict:
    """sum_i (i+1) T[i] over (nb, 16) rows, nb a power of two: with groups
    of m = min(nb, _GROUP) rows and i = g*m + j,
        total = m * sum_g g*S_g + sum_g W_g.
    sum_g g*S_g is the W output of the table T'_i = S_{i+1} and sum_g W_g
    the S output of the W table: one more K5 call over both, then log2(m)
    doublings (K3) and one add (K2). Returns (1, 16) XYZZ coordinates."""
    nb = table["x"].shape[0]
    assert nb & (nb - 1) == 0 and nb >= 2
    m = min(nb, _GROUP)
    G = nb // m
    S, Wg = bucket_reduce_groups(tf, table, m)
    if G == 1:
        return Wg

    def padded(src, shift):
        z = src["x"].new_zeros((m - G + shift, NUM_LIMBS))
        return {k: torch.cat([src[k][shift:], z]) for k in KEYS}

    T1, T2 = padded(S, 1), padded(Wg, 0)
    S2, W2 = bucket_reduce_groups(
        tf, {k: torch.cat([T1[k], T2[k]]) for k in KEYS}, m
    )
    acc = {k: W2[k][:1] for k in KEYS}  # sum_g g*S_g
    for _ in range(int(np.log2(m))):
        acc = xyzz_double(tf, acc)
    return xyzz_add(tf, acc, {k: S2[k][1:2] for k in KEYS})


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
    and (W*n,) inf flags: per window c doublings (K3), then one batched
    inversion over [zz; zzz] (K1). Run once per (key, size) and cached."""
    n = bx.shape[0]
    one = tf.one_mont(bx)
    zz0 = torch.where(binf[:, None], torch.zeros_like(bx), one)
    pts = {"x": bx, "y": by, "zz": zz0, "zzz": zz0}
    xs, ys, infs = [bx], [by], [binf]
    for _ in range(W - 1):
        for _ in range(c):
            pts = xyzz_double(tf, pts)
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
            W = (255 + c - 1) // c + 1
            fx, fy, finf = _precompute_shifted(self.tf, c, W, bx, by, binf)
            self.set_fixed(c, n_pad, fx, fy, finf)
        return self._fixed[key]

    def set_fixed(self, c: int, n_pad: int, fx, fy, finf) -> None:
        """Install a precompute computed elsewhere (see interop)."""
        self._fixed[(c, n_pad)] = (fx, fy, _negate_y(self.tf, fy), finf)


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
