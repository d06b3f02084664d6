"""The port's FVec (on CPU tensors) against nova_tpu.ops.fvec.FVec: the
Montgomery limbs of every op are bitwise equal, and the host views
(to_ints, limbs64, HVec) agree."""

import numpy as np
import torch

from nova_tpu.fields.jfield import JField
from nova_tpu.fields.spec import pallas_scalar as jscalar
from nova_tpu.ops.fvec import FVec as JFVec
from nova_tpu.ops.fvec import HVec as JHVec

from nova_tpu_torch import interop
from nova_tpu_torch.fields.spec import pallas_scalar as tscalar
from nova_tpu_torch.ops.fvec import FVec, HVec, as_list

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)


def _same(j: JFVec, t: FVec) -> bool:
    return np.array_equal(np.asarray(j.m).astype(np.int64), t.m.numpy().astype(np.int64))


def test_fvec_ops_bitwise():
    p = tscalar.p
    rng = np.random.default_rng(11)
    vals = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(40)]
            for _ in range(3)]
    vals[0][:3] = [0, 1, p - 1]
    jf = JField(jscalar)
    ja, jb, jc = (JFVec.from_ints(jf, v) for v in vals)
    ta, tb, tc = (FVec.from_ints(tscalar, v, device="cpu") for v in vals)
    r, r2 = 0x1234567890ABCDEF, p - 3

    assert _same(ja, ta)
    assert ta.device == torch.device("cpu")
    assert _same(ja.axpy(r, jb), ta.axpy(r, tb))
    assert _same(ja.axpy2(r, jb, r2, jc), ta.axpy2(r, tb, r2, tc))
    assert _same(ja.add(jb), ta.add(tb))
    assert _same(ja.sub(jb), ta.sub(tb))
    assert _same(ja.mul(jb), ta.mul(tb))
    assert _same(ja.scale(r), ta.scale(r))
    assert _same(ja.pad_to(50), ta.pad_to(50))
    assert _same(ja.concat_ints([7, 9]), ta.concat_ints([7, 9]))
    assert _same(JFVec.zeros(jf, 5), FVec.zeros(tscalar, 5, device="cpu"))

    # host views, recomputed from the limbs (no cached ints)
    fresh = interop.fvec(tscalar, np.asarray(ja.axpy(r, jb).m), device="cpu")
    want = [(x + r * y) % p for x, y in zip(vals[0], vals[1])]
    assert fresh.to_ints() == want and list(fresh) == want and fresh[5] == want[5]
    assert len(fresh) == 40 and fresh == want
    jl = JFVec(jf, ja.axpy(r, jb).m).limbs64()
    assert np.array_equal(fresh.limbs64(), jl)
    assert as_list(fresh) == want


def test_hvec_matches():
    p = tscalar.p
    ints = [p - 1, 0, 1, 12345678901234567890123]
    jh, th = JHVec(p, ints=ints), HVec(p, ints=ints)
    assert np.array_equal(th.limbs64(), jh.limbs64())
    back = HVec(p, limbs=th.limbs64())
    assert back.to_ints() == ints and back == ints and len(back) == 4
