"""The port's headline bench twin's msm1 stage (``nova_tpu_torch/bench.py::
bench_msm("msm1")``, the DeviceBases program of ops/msm.py) on the CPU at
2^10 points: its first result equals the native host MSM (checked inside
bench_msm); ~12 s a call on the plain versions. Tolerance: exact (affine
points)."""

import torch

from nova_tpu_torch import bench

torch.set_num_threads(1)


def test_bench_msm1_equals_host_msm():
    rate = bench.bench_msm("msm1", n=1 << 10, device="cpu", iters=1)
    assert rate > 0
