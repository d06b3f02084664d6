"""Device sumcheck (port of ``nova_tpu/ops/sumcheck.py``).

Each round of the outer cubic sumcheck is two passes over tables resident
on the device as ``(N, 16)`` int32 Montgomery limbs (the FVec layout):

  1. round sums: the three interpolation sums (P(0), leading coeff, P(-1))
     over the bottom/top halves of the tables: Montgomery products (kernel
     K1 on CUDA tensors) and field sub/add, then a halving-add tree;
  2. bind: Z' = lo + r*(hi - lo) for every table, halving them.

Only the three sums of a round cross to the host for the transcript, and
the challenge r crosses back. Where the reference runs one jitted program
per table, the port stacks the tables of a pass into one tensor, so each
field op is one launch for all of them. Tables live on CUDA unless the
caller names another device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from nova_tpu_torch._device import resolve
from nova_tpu_torch.fields.spec import NUM_LIMBS, FieldSpec
from nova_tpu_torch.fields.tfield import TField


def _field_tree_sum(tf: TField, arr):
    """(..., N, 16) Montgomery -> (..., 16) field sums via halving adds; an
    odd level gets one zero row."""
    v = arr
    while v.shape[-2] > 1:
        n = v.shape[-2]
        if n % 2 == 1:
            v = torch.cat([v, v.new_zeros(v.shape[:-2] + (1, NUM_LIMBS))], dim=-2)
            n += 1
        v = tf.add(v[..., : n // 2, :], v[..., n // 2:, :])
    return v[..., 0, :]


def _std_limbs16(values) -> np.ndarray:
    """(n, 16) int32 16-bit standard-form limbs of an HVec or an int list."""
    from nova_tpu_torch.ops.fvec import HVec

    if isinstance(values, HVec):
        l64 = np.ascontiguousarray(values.limbs64().astype("<u8"))
        return l64.view("<u2").reshape(-1, NUM_LIMBS).astype(np.int32)
    n = len(values)
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(n, NUM_LIMBS).astype(np.int32)


def cubic_round_sums(tf: TField, T):
    """The three interpolation sums (P(0), leading coeff, P(-1)) of
    sum eq * (A*B - C) over the halves of the stacked (4, N, 16) Montgomery
    tables [eq, A, B, C], as (3, 16) Montgomery rows."""
    half = T.shape[1] // 2
    lo, hi = T[:, :half], T[:, half:]
    d = tf.sub(hi, lo)   # de, da, db, dc
    m = tf.sub(lo, d)    # the tables at -1: elo - de, alo - da, ...
    ab = tf.mont_mul(torch.stack([lo[1], d[1], m[1]]), torch.stack([lo[2], d[2], m[2]]))
    ab_c = tf.sub(torch.stack([ab[0], ab[2]]), torch.stack([lo[3], m[3]]))
    inner = torch.stack([ab_c[0], ab[1], ab_c[1]])
    terms = tf.mont_mul(torch.stack([lo[0], d[0], m[0]]), inner)
    return _field_tree_sum(tf, terms)


def bind_top(tf: TField, r: int, T):
    """Bind the top variable of stacked (k, N, 16) Montgomery tables:
    lo + r*(hi - lo), (k, N/2, 16)."""
    half = T.shape[1] // 2
    lo, hi = T[:, :half], T[:, half:]
    return tf.add(lo, tf.mont_mul(tf.const_mont(r % tf.spec.p, lo), tf.sub(hi, lo)))


class DevicePoly:
    """A multilinear evaluation table resident on a device (Montgomery)."""

    __slots__ = ("tf", "Z", "n")

    def __init__(self, field: FieldSpec, values, device=None):
        self.tf = TField(field)
        raw = torch.from_numpy(_std_limbs16(values)).to(resolve(device))
        self.Z = self.tf.to_mont(raw)
        self.n = int(self.Z.shape[0])

    def to_host(self) -> List[int]:
        return self.tf.unpack(self.tf.from_mont(self.Z))

    def final_value(self) -> int:
        assert self.n == 1
        return self.to_host()[0]


class DeviceSumcheck:
    """Drives device-resident sumcheck rounds; the transcript stays on the
    host."""

    def __init__(self, field: FieldSpec):
        self.field = field
        self.tf = TField(field)

    def _out(self, sums) -> List[int]:
        return self.tf.unpack(self.tf.from_mont(sums))

    def cubic_eq_round(self, eq: DevicePoly, A: DevicePoly, B: DevicePoly, C: DevicePoly):
        """(P(0), leading coeff, P(-1)) of sum eq * (A*B - C)."""
        T = torch.stack([eq.Z, A.Z, B.Z, C.Z])
        e0, c3, em1 = self._out(cubic_round_sums(self.tf, T))
        return e0, c3, em1

    def bind(self, r: int, polys: List[DevicePoly]):
        """Bind the top variable of every table: Z' = lo + r*(hi - lo)."""
        out = bind_top(self.tf, r, torch.stack([pl.Z for pl in polys]))
        half = out.shape[1]
        for pl, z in zip(polys, out):
            pl.Z = z
            pl.n = half


def prove_cubic_with_three_inputs_device(
    field: FieldSpec, claim: int, taus: Sequence[int], Az, Bz, Cz, transcript,
    device=None,
) -> Tuple[object, List[int], List[int]]:
    """Device-resident variant of SumcheckProof.prove_cubic_with_three_inputs
    (same transcript and proof). Az/Bz/Cz are int lists or HVecs; the
    tables live on `device` (CUDA unless given)."""
    from nova_tpu_torch.spartan.polys import EqPolynomial, UniPoly
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    p = field.p
    dev = resolve(device)
    sc = DeviceSumcheck(field)
    eq = DevicePoly(field, EqPolynomial.evals_hvec(field, list(taus)), device=dev)
    A = DevicePoly(field, Az, device=dev)
    B = DevicePoly(field, Bz, device=dev)
    C = DevicePoly(field, Cz, device=dev)

    r_out: List[int] = []
    polys = []
    claim_per_round = claim % p
    for _ in range(len(taus)):
        e0, c3, em1 = sc.cubic_eq_round(eq, A, B, C)
        poly = UniPoly.from_evals_deg3(field, [e0, (claim_per_round - e0) % p, c3, em1])
        transcript.absorb(b"p", poly)
        r_i = transcript.squeeze(b"c")
        r_out.append(r_i)
        polys.append(poly.compress())
        claim_per_round = poly.evaluate(r_i)
        sc.bind(r_i, [eq, A, B, C])

    return (
        SumcheckProof(polys),
        r_out,
        [A.final_value(), B.final_value(), C.final_value()],
    )
