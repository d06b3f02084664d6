"""nova_tpu_torch stands alone: it imports neither jax nor nova_tpu, its
entry points default to CUDA and raise without a card, and its kernel
wrappers take their plain versions only for CPU tensors."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nova_tpu_torch")

_BAD_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+nova_tpu(\.|\s|$)|from\s+nova_tpu(\.|\s))",
    re.M,
)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_import_leaves_jax_and_nova_tpu_out():
    code = (
        "import sys\n"
        "import nova_tpu_torch, nova_tpu_torch.interop\n"
        "import nova_tpu_torch.ops.msm3, nova_tpu_torch.provider.pedersen\n"
        "import nova_tpu_torch.fields.tfield, nova_tpu_torch.curves.points\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'nova_tpu' or m.startswith('nova_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
    )
    assert out.returncode == 0 and "clean" in out.stdout, out.stdout


def test_source_scan_finds_no_jax_or_nova_tpu_import():
    files = _sources()
    assert len(files) > 10
    for path in files:
        with open(path) as fh:
            text = fh.read()
        assert not _BAD_IMPORT.search(text), path


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.ops.msm2 import DeviceBases2

    with pytest.raises(RuntimeError, match="CUDA"):
        FVec.from_ints(pallas.scalar, [1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBases2(pallas, [])
    v = FVec.from_ints(pallas.scalar, [1, 2, 3], device="cpu")
    assert v.device.type == "cpu" and v.to_ints() == [1, 2, 3]


def test_wrappers_refuse_mixed_devices():
    from nova_tpu_torch.fields.spec import pallas_base
    from nova_tpu_torch.fields.tfield import TField

    tf = TField(pallas_base)
    a = torch.zeros((2, 16), dtype=torch.int32)
    b = a.to("meta")
    with pytest.raises(ValueError):
        tf.mont_mul(a, b)


def test_interop_rejects_bad_limbs():
    import numpy as np

    from nova_tpu_torch import interop

    with pytest.raises(ValueError):
        interop.limbs(np.zeros((2, 16), np.int64), "cpu")
    with pytest.raises(ValueError):
        interop.limbs(np.full((2, 16), 1 << 16, np.uint32), "cpu")
