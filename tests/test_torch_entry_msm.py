"""The port's headline bench twin's MSM stage (``nova_tpu_torch/bench.py::
bench_msm``) on the CPU at 2^10 points, each fixed-base engine (msm1:
tests/test_torch_entry_msm1.py): its first result equals the native host
MSM (checked inside bench_msm). The msm2/msm3 key
precompute is the native binding's (tests/test_torch_parallel.py::
native_fixed, equal rows), as the mesh tests install it: the plain one
costs ~10 s a window size on the CPU. Tolerance: exact (affine points)."""

import pytest
import torch

from nova_tpu_torch import bench
from nova_tpu_torch.curves.spec import AffinePoint, pallas

from tests.test_torch_parallel import native_precompute  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("engine", ["msm3m", "msm3", "msm2"])
def test_bench_msm_equals_host_msm(engine, native_precompute, monkeypatch):  # noqa: F811
    """bench_msm at 2^10 on the CPU: its first result equals the native
    host MSM (checked inside), and a different host result fails it."""
    out = bench.bench_msm(engine, n=1 << 10, device="cpu", iters=1)
    rates = out if isinstance(out, tuple) else (out,)
    assert len(rates) == (2 if engine == "msm3m" else 1)
    assert all(r > 0 for r in rates)
    if engine == "msm2":
        g = AffinePoint.generator(pallas)
        monkeypatch.setattr(bench, "_host_msm", lambda ck, s: g)
        with pytest.raises(AssertionError, match="host MSM"):
            bench.bench_msm(engine, n=1 << 10, device="cpu", iters=1)


