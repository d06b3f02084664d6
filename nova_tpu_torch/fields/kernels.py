"""Kernels K1-K3 (Montgomery multiply, XYZZ add, XYZZ double) and their
plain PyTorch versions.

Each wrapper takes the public layout, ``(..., 16)`` int32 tensors of 16-bit
limbs in Montgomery form. On CUDA tensors it launches its kernel from
``csrc/field_kernels.cu`` (or raises); on CPU tensors it runs the plain
version. The plain versions are the limb formulas of
``nova_tpu/ops/msm2.py`` (``_limb_ops``, ``_xyzz_add_limbs``,
``_xyzz_add_limbs_fast``, ``_xyzz_double_limbs``) written on ``(..., 16)``
int64 tensors; the kernels compute the same values bit for bit.

Replaces: ``nova_tpu/fields/pallas_kernels.py::_mont_mul_2d`` (K1),
``_xyzz_add_call`` (K2) and ``_xyzz_double_call`` (K3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nova_tpu_torch import _build
from nova_tpu_torch._device import on_cuda
from nova_tpu_torch.fields.spec import NUM_LIMBS

MASK = 0xFFFF
KEYS = ("x", "y", "zz", "zzz")


# ---------------------------------------------------------------------------
# plain versions: limb formulas on (..., 16) int64 tensors
# ---------------------------------------------------------------------------


class LimbOps:
    """Field ops of one field on one device, on ``(..., 16)`` int64 tensors
    of 16-bit limbs (msm2._limb_ops semantics: add/dbl reduce once, sub
    adds p back on borrow, mul is the 16-step Montgomery product)."""

    def __init__(self, tf, device):
        self.p = torch.tensor(tf.p_limbs, dtype=torch.int64, device=device)
        self.r = torch.tensor(tf.r_limbs, dtype=torch.int64, device=device)
        self.n0 = int(tf.n0inv)
        self.p0 = int(tf.p_limbs[0])

    @staticmethod
    def _carry(cols, carry=None):
        """Carry-propagate non-negative columns into exact 16-bit limbs;
        returns (limbs, final carry)."""
        out = []
        c = carry
        for i in range(cols.shape[-1]):
            v = cols[..., i] if c is None else cols[..., i] + c
            out.append(v & MASK)
            c = v >> 16
        return torch.stack(out, dim=-1), c

    def cond_sub(self, limbs, overflow=None):
        """limbs - p when limbs >= p (or `overflow` > 0), modulo 2^256."""
        out = []
        borrow = None
        for i in range(NUM_LIMBS):
            d = limbs[..., i] - self.p[i]
            if borrow is not None:
                d = d - borrow
            out.append(d & MASK)
            borrow = (d >> 63) & 1
        need = borrow == 0
        if overflow is not None:
            need = need | (overflow > 0)
        return torch.where(need[..., None], torch.stack(out, dim=-1), limbs)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        batch = a.shape[:-1]
        prod = a[..., :, None] * b[..., None, :]  # (..., 16, 16) < 2^32
        # anti-diagonal sums: padding rows to 33 aligns 33i+j with 32i+(i+j)
        f = F.pad(prod, (0, 17)).reshape(batch + (16 * 33,))[..., : 16 * 32]
        cols = f.reshape(batch + (16, 32)).sum(dim=-2)  # (..., 32) < 2^37
        carry = None
        for i in range(NUM_LIMBS):
            t = cols[..., i] if carry is None else cols[..., i] + carry
            m = (t * self.n0) & MASK
            carry = (t + m * self.p0) >> 16
            cols[..., i + 1 : i + NUM_LIMBS] += m[..., None] * self.p[1:]
        limbs, c = self._carry(cols[..., NUM_LIMBS:], carry)
        return self.cond_sub(limbs, c)

    def add(self, a, b):
        limbs, c = self._carry(a + b)
        return self.cond_sub(limbs, c)

    def sub(self, a, b):
        d = a - b
        out = []
        borrow = None
        for i in range(NUM_LIMBS):
            v = d[..., i] if borrow is None else d[..., i] - borrow
            out.append(v & MASK)
            borrow = (v >> 63) & 1
        diff = torch.stack(out, dim=-1)
        limbs, _ = self._carry(diff + torch.where(borrow[..., None] > 0, self.p, 0))
        return limbs

    def dbl(self, a):
        return self.add(a, a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1)

    @staticmethod
    def sel(cond, a, b):
        return torch.where(cond[..., None], a, b)

    def one(self, like):
        return self.r.expand(like.shape)

    @staticmethod
    def zero(like):
        return torch.zeros_like(like)


def xyzz_add_limbs(o: LimbOps, P, Q):
    """Complete XYZZ + XYZZ (msm2._xyzz_add_limbs; plain K2)."""
    X1, Y1, ZZ1, ZZZ1 = P
    X2, Y2, ZZ2, ZZZ2 = Q
    u_dbl = o.dbl(Y1)
    u1 = o.mul(X1, ZZ2)
    u2 = o.mul(X2, ZZ1)
    s1 = o.mul(Y1, ZZZ2)
    s2 = o.mul(Y2, ZZZ1)
    v_dbl = o.mul(u_dbl, u_dbl)
    xsq = o.mul(X1, X1)
    pd = o.sub(u2, u1)
    r = o.sub(s2, s1)
    m_dbl = o.add(o.dbl(xsq), xsq)

    pp = o.mul(pd, pd)
    rr = o.mul(r, r)
    zzp = o.mul(ZZ1, ZZ2)
    zzzp = o.mul(ZZZ1, ZZZ2)
    w_dbl = o.mul(u_dbl, v_dbl)
    s_dbl = o.mul(X1, v_dbl)
    mm_dbl = o.mul(m_dbl, m_dbl)
    x3_dbl = o.sub(mm_dbl, o.dbl(s_dbl))

    ppp = o.mul(pd, pp)
    qq = o.mul(u1, pp)
    zz3 = o.mul(zzp, pp)
    zz3_dbl = o.mul(ZZ1, v_dbl)
    zzz3_dbl = o.mul(ZZZ1, w_dbl)
    wy_dbl = o.mul(w_dbl, Y1)
    x3 = o.sub(o.sub(rr, ppp), o.dbl(qq))

    t1 = o.mul(r, o.sub(qq, x3))
    t2 = o.mul(s1, ppp)
    zzz3 = o.mul(zzzp, ppp)
    ms_dbl = o.mul(m_dbl, o.sub(s_dbl, x3_dbl))
    y3 = o.sub(t1, t2)
    y3_dbl = o.sub(ms_dbl, wy_dbl)

    p_zero = o.is_zero(ZZ1)
    q_zero = o.is_zero(ZZ2)
    eq_u = o.is_zero(pd)
    eq_s = o.is_zero(r)
    KONE = o.one(X1)
    KZERO = o.zero(X1)

    dblx = o.sel(~p_zero, x3_dbl, X1)
    dbly = o.sel(~p_zero, y3_dbl, Y1)
    dblzz = o.sel(~p_zero, zz3_dbl, ZZ1)
    dblzzz = o.sel(~p_zero, zzz3_dbl, ZZZ1)

    def pick(res_n, res_d, res_z, pc, qc):
        out = o.sel(eq_u & eq_s, res_d, res_n)
        out = o.sel(eq_u & ~eq_s, res_z, out)
        out = o.sel(p_zero, qc, out)
        return o.sel(q_zero & ~p_zero, pc, out)

    return (
        pick(x3, dblx, KONE, X1, X2),
        pick(y3, dbly, KONE, Y1, Y2),
        pick(zz3, dblzz, KZERO, ZZ1, ZZ2),
        pick(zzz3, dblzzz, KZERO, ZZZ1, ZZZ2),
    )


def xyzz_add_limbs_fast(o: LimbOps, P, Q):
    """XYZZ + XYZZ without the doubling path (msm2._xyzz_add_limbs_fast):
    returns (coords, bad) where bad flags P = +-Q lanes."""
    X1, Y1, ZZ1, ZZZ1 = P
    X2, Y2, ZZ2, ZZZ2 = Q
    u1 = o.mul(X1, ZZ2)
    u2 = o.mul(X2, ZZ1)
    s1 = o.mul(Y1, ZZZ2)
    s2 = o.mul(Y2, ZZZ1)
    pd = o.sub(u2, u1)
    r = o.sub(s2, s1)
    pp = o.mul(pd, pd)
    rr = o.mul(r, r)
    zzp = o.mul(ZZ1, ZZ2)
    zzzp = o.mul(ZZZ1, ZZZ2)
    ppp = o.mul(pd, pp)
    qq = o.mul(u1, pp)
    zz3 = o.mul(zzp, pp)
    x3 = o.sub(o.sub(rr, ppp), o.dbl(qq))
    t1 = o.mul(r, o.sub(qq, x3))
    t2 = o.mul(s1, ppp)
    zzz3 = o.mul(zzzp, ppp)
    y3 = o.sub(t1, t2)

    p_zero = o.is_zero(ZZ1)
    q_zero = o.is_zero(ZZ2)
    eq_u = o.is_zero(pd)

    def pick(res, pc, qc):
        out = o.sel(p_zero, qc, res)
        return o.sel(q_zero & ~p_zero, pc, out)

    out = (pick(x3, X1, X2), pick(y3, Y1, Y2), pick(zz3, ZZ1, ZZ2),
           pick(zzz3, ZZZ1, ZZZ2))
    return out, eq_u & ~p_zero & ~q_zero


def xyzz_double_limbs(o: LimbOps, P):
    """XYZZ doubling dbl-2008-s-1, a = 0, identity-masked
    (msm2._xyzz_double_limbs; plain K3)."""
    X1, Y1, ZZ1, ZZZ1 = P
    u = o.dbl(Y1)
    v = o.mul(u, u)
    x_sq = o.mul(X1, X1)
    w = o.mul(u, v)
    s = o.mul(X1, v)
    zz3 = o.mul(ZZ1, v)
    m = o.add(o.dbl(x_sq), x_sq)
    mm = o.mul(m, m)
    zzz3 = o.mul(ZZZ1, w)
    x3 = o.sub(mm, o.dbl(s))
    t1 = o.mul(m, o.sub(s, x3))
    t2 = o.mul(w, Y1)
    y3 = o.sub(t1, t2)
    nz = ~o.is_zero(ZZ1)
    return (o.sel(nz, x3, X1), o.sel(nz, y3, Y1), o.sel(nz, zz3, ZZ1),
            o.sel(nz, zzz3, ZZZ1))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def check_i32(*ts):
    """The tensors as the kernels take them: int32, contiguous, and 16-byte
    aligned for the 16 B vector loads (misaligned views are copied)."""
    out = []
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"kernel inputs are int32, got {t.dtype}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _rows(t, shape):
    """(..., 16) int32 tensor broadcast to `shape`, as kernel-ready rows."""
    return check_i32(t.expand(shape).reshape(-1, NUM_LIMBS))[0]


def mont_mul(tf, a, b):
    """K1: Montgomery product a*b*R^-1 mod p of (..., 16) int32 limbs."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if not on_cuda(a, b):
        o = tf.ops(a.device)
        return o.mul(a.long(), b.long()).expand(shape).to(torch.int32)
    a2, b2 = _rows(a, shape), _rows(b, shape)
    out = torch.empty_like(a2)
    n = a2.shape[0]
    if n:
        with torch.cuda.device(out.device):
            err = _build.lib().nt_mont_mul(
                a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n,
                tf.consts_ptr, _build.stream_of(out),
            )
            _build.check(err, "mont_mul")
            _build.LAUNCHES["mont_mul"] += 1
    return out.view(shape)


def xyzz_add(tf, p: dict, q: dict) -> dict:
    """K2: complete XYZZ + XYZZ on dicts of (..., 16) int32 coordinates."""
    ins = [p[k] for k in KEYS] + [q[k] for k in KEYS]
    shape = torch.broadcast_shapes(*(t.shape for t in ins))
    if not on_cuda(*ins):
        o = tf.ops(ins[0].device)
        res = xyzz_add_limbs(
            o, tuple(t.long() for t in ins[:4]), tuple(t.long() for t in ins[4:])
        )
        return {k: v.expand(shape).to(torch.int32) for k, v in zip(KEYS, res)}
    rows = [_rows(t, shape) for t in ins]
    outs = [torch.empty_like(rows[0]) for _ in KEYS]
    n = rows[0].shape[0]
    if n:
        with torch.cuda.device(rows[0].device):
            err = _build.lib().nt_xyzz_add(
                *(t.data_ptr() for t in rows), *(t.data_ptr() for t in outs),
                n, tf.consts_ptr, _build.stream_of(rows[0]),
            )
            _build.check(err, "xyzz_add")
            _build.LAUNCHES["xyzz_add"] += 1
    return {k: v.view(shape) for k, v in zip(KEYS, outs)}


def xyzz_double(tf, p: dict) -> dict:
    """K3: XYZZ doubling (identity maps to itself) on a dict of (..., 16)
    int32 coordinates."""
    ins = [p[k] for k in KEYS]
    shape = torch.broadcast_shapes(*(t.shape for t in ins))
    if not on_cuda(*ins):
        o = tf.ops(ins[0].device)
        res = xyzz_double_limbs(o, tuple(t.long() for t in ins))
        return {k: v.expand(shape).to(torch.int32) for k, v in zip(KEYS, res)}
    rows = [_rows(t, shape) for t in ins]
    outs = [torch.empty_like(rows[0]) for _ in KEYS]
    n = rows[0].shape[0]
    if n:
        with torch.cuda.device(rows[0].device):
            err = _build.lib().nt_xyzz_double(
                *(t.data_ptr() for t in rows), *(t.data_ptr() for t in outs),
                n, tf.consts_ptr, _build.stream_of(rows[0]),
            )
            _build.check(err, "xyzz_double")
            _build.LAUNCHES["xyzz_double"] += 1
    return {k: v.view(shape) for k, v in zip(KEYS, outs)}
