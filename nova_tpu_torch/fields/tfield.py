"""TField: Montgomery field arithmetic on PyTorch tensors.

Port of ``nova_tpu/fields/jfield.py``. A vector of N field elements is an
``(N, 16)`` int32 tensor of 16-bit little-endian limbs in Montgomery form
(x*R mod p, R = 2^256): the JAX package's layout, so tests compare like
with like. The limbs are below 2^16, so int32 holds the same bits as the
reference's uint32 (PyTorch's uint32 has almost no arithmetic).

``mont_mul`` is kernel K1 on CUDA tensors; everything else is plain
PyTorch on whatever device the tensors live (``add``/``sub`` are XLA in
the reference too, not Pallas). Plain arithmetic runs in int64 lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from nova_tpu_torch import profiling
from nova_tpu_torch.fields import kernels
from nova_tpu_torch.fields.spec import NUM_LIMBS, FieldSpec, to_limbs

_I32 = torch.int32


class TField:
    """Tensor engine bound to one FieldSpec (one instance per modulus)."""

    _instances: dict = {}

    def __new__(cls, spec: FieldSpec):
        if spec.p in cls._instances:
            return cls._instances[spec.p]
        self = super().__new__(cls)
        self.spec = spec
        self.p_limbs = tuple(int(x) for x in spec.p_limbs)
        self.n0inv = int(spec.n0inv)
        self.r_limbs = tuple(to_limbs(spec.r))  # Montgomery one
        self.r2_limbs = tuple(to_limbs(spec.r2))
        e = spec.p - 2
        self.inv_exp_bits = [(e >> i) & 1 for i in range(spec.num_bits)]
        # kernel constants: p and R mod p as 8 x 32-bit words, -p^-1 mod 2^32
        words = [(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
        words += [(spec.r >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
        words.append((-pow(spec.p, -1, 1 << 32)) % (1 << 32))
        self.consts32 = np.array(words, dtype=np.uint32)
        self.consts_ptr = self.consts32.ctypes.data
        self._ops = {}
        self._consts = {}
        cls._instances[spec.p] = self
        return self

    def ops(self, device) -> kernels.LimbOps:
        """Plain limb ops (int64 lanes) on `device`, cached."""
        key = str(torch.device(device))
        if key not in self._ops:
            self._ops[key] = kernels.LimbOps(self, device)
        return self._ops[key]

    def _const(self, limbs, device):
        """One of the field's fixed constants (R, R^2, 1) on `device`,
        cached."""
        key = (limbs, str(torch.device(device)))
        if key not in self._consts:
            self._consts[key] = torch.tensor(limbs, dtype=_I32, device=device)
        return self._consts[key]

    # ------------------------------------------------------------------
    # host <-> device marshalling
    # ------------------------------------------------------------------

    def pack(self, values) -> np.ndarray:
        """Python ints (standard form) -> (N, 16) int32 numpy limbs (still
        standard form; call to_mont for compute)."""
        n = len(values)
        profiling.count("conv.to_device", n)
        buf = b"".join(int(v).to_bytes(32, "little") for v in values)
        u16 = np.frombuffer(buf, dtype="<u2").reshape(n, NUM_LIMBS)
        return u16.astype(np.int32)

    def unpack(self, arr) -> list:
        """(N, 16) limbs (tensor or array) -> list of Python ints."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr).astype(np.uint16)
        profiling.count("conv.to_host", a.shape[0])
        return [
            int.from_bytes(row.astype("<u2").tobytes(), "little") for row in a
        ]

    # ------------------------------------------------------------------
    # modular arithmetic on (..., 16) int32 limbs
    # ------------------------------------------------------------------

    def add(self, a, b):
        return self.ops(a.device).add(a.long(), b.long()).to(_I32)

    def sub(self, a, b):
        return self.ops(a.device).sub(a.long(), b.long()).to(_I32)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mont_mul(self, a, b):
        """a*b*R^-1 mod p (kernel K1 on CUDA tensors)."""
        return kernels.mont_mul(self, a, b)

    def square(self, a):
        return self.mont_mul(a, a)

    def to_mont(self, a):
        return self.mont_mul(a, self._const(self.r2_limbs, a.device))

    def from_mont(self, a):
        one = (1,) + (0,) * (NUM_LIMBS - 1)
        return self.mont_mul(a, self._const(one, a.device))

    def one_mont(self, shape_like):
        """Montgomery 1 (= R mod p) broadcast to `shape_like`'s shape."""
        return self._const(self.r_limbs, shape_like.device).expand(
            shape_like.shape
        )

    def const_mont(self, value: int, shape_like):
        """A constant (standard-form int) in Montgomery form, broadcast."""
        m = to_limbs(self.spec.to_mont(value % self.spec.p))
        t = torch.tensor(m, dtype=_I32, device=shape_like.device)
        return t.expand(shape_like.shape)

    def zero(self, shape_like):
        return torch.zeros_like(shape_like)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def select(self, cond, a, b):
        """where(cond, a, b) with cond (...,) broadcast over limbs."""
        return torch.where(cond[..., None], a, b)

    def _cond_sub_int(self, limbs, k: int):
        """limbs - k*p when limbs >= k*p (k*p < 2^256), else limbs."""
        kp = k * self.spec.p
        if kp >= 1 << (16 * NUM_LIMBS):
            return limbs
        kp_l = to_limbs(kp)
        out = []
        borrow = None
        for i in range(NUM_LIMBS):
            d = limbs[..., i] - kp_l[i]
            if borrow is not None:
                d = d - borrow
            out.append(d & kernels.MASK)
            borrow = (d >> 63) & 1
        return torch.where((borrow == 0)[..., None], torch.stack(out, -1), limbs)

    def reduce_wide(self, cols):
        """Reduce a redundant column value (list of K non-negative (...,)
        integer columns, each < 2^31, 16 <= K <= 32) to canonical limbs < p.

        X = X_lo + 2^256 * X_hi; X_hi * 2^256 mod p = mont_mul(X_hi, R^2);
        X_lo < 2^256 < 4p is fixed by conditional subtracts of 2p, p, p."""
        assert len(cols) <= 2 * NUM_LIMBS
        o = self.ops(cols[0].device)
        stacked = torch.stack([c.long() for c in cols], dim=-1)
        limbs, carry = o._carry(stacked)
        limbs = torch.cat([limbs, carry[..., None]], dim=-1)  # K+1 limbs
        lo = limbs[..., :NUM_LIMBS]
        hi = limbs[..., NUM_LIMBS:]
        lo = self._cond_sub_int(lo, 2)
        lo = self._cond_sub_int(lo, 1)
        lo = self._cond_sub_int(lo, 1)
        pad = NUM_LIMBS - hi.shape[-1]
        hi = torch.cat(
            [hi, torch.zeros(hi.shape[:-1] + (pad,), dtype=hi.dtype,
                             device=hi.device)], dim=-1,
        )
        hi_red = self.mont_mul(
            hi.to(_I32), self._const(self.r2_limbs, hi.device)
        )
        return self.add(lo.to(_I32), hi_red)

    def mul_small(self, a, k_arr):
        """a * k for small k < 2^15 (k_arr shape (...,)), staying in the same
        (Montgomery) domain."""
        prod = a.long() * k_arr.long()[..., None]  # (..., 16) < 2^31
        zero = torch.zeros_like(prod[..., :1])
        acc = torch.cat([prod & kernels.MASK, zero], -1) + torch.cat(
            [zero, prod >> 16], -1
        )
        return self.reduce_wide([acc[..., i] for i in range(NUM_LIMBS + 1)])

    def pow_fixed(self, a, exp_bits):
        """a^e over static exponent bits (LSB first), Montgomery in/out.
        Multiplies only at set bits; the reference's select-every-bit scan
        applies the same products, so the value is the same."""
        result = self.one_mont(a)
        base = a
        last = max((i for i, b in enumerate(exp_bits) if b), default=-1)
        for i in range(last + 1):
            if exp_bits[i]:
                result = self.mont_mul(result, base)
            if i < last:
                base = self.mont_mul(base, base)
        return result

    def inv(self, a):
        """Fermat inversion a^(p-2) (maps 0 -> 0)."""
        return self.pow_fixed(a, self.inv_exp_bits)

    def batch_inv_tree(self, a):
        """Batch inversion via a product tree: ~3 muls/element + one Fermat
        inversion. `a` is (N, 16), N a power of two; zeros map to zero."""
        n = a.shape[0]
        assert n & (n - 1) == 0, "batch_inv_tree needs power-of-two N"
        one = self.one_mont(a)
        is_z = self.is_zero(a)
        a_safe = self.select(is_z, one, a)
        levels = [a_safe]
        cur = a_safe
        while cur.shape[0] > 1:
            cur = self.mont_mul(cur[0::2], cur[1::2])
            levels.append(cur)
        inv = self.inv(levels[-1])
        for lvl in reversed(levels[:-1]):
            left, right = lvl[0::2], lvl[1::2]
            inv_left = self.mont_mul(inv, right)
            inv_right = self.mont_mul(inv, left)
            inv = torch.stack([inv_left, inv_right], dim=1).reshape(-1, NUM_LIMBS)
        return self.select(is_z, torch.zeros_like(a), inv)
