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
        "import nova_tpu_torch.ops.msm2, nova_tpu_torch.ops.spmv, nova_tpu_torch.ops.fold\n"
        "import nova_tpu_torch.r1cs, nova_tpu_torch.digest, nova_tpu_torch.profiling\n"
        "import nova_tpu_torch.provider.poseidon, nova_tpu_torch.provider.keccak\n"
        "import nova_tpu_torch.provider.engines, nova_tpu_torch.frontend\n"
        "import nova_tpu_torch.frontend.tape, nova_tpu_torch.gadgets.utils\n"
        "import nova_tpu_torch.gadgets.ecc, nova_tpu_torch.gadgets.bignat\n"
        "import nova_tpu_torch.gadgets.poseidon_circuit, nova_tpu_torch.nova\n"
        "import nova_tpu_torch.nova.circuit, nova_tpu_torch.nova.ivc\n"
        "import nova_tpu_torch.native, nova_tpu_torch.spartan, nova_tpu_torch.spartan.snark\n"
        "import nova_tpu_torch.ops.sumcheck, nova_tpu_torch.provider.ipa\n"
        "import nova_tpu_torch.nova.compressed, nova_tpu_torch.perf.ubench_field\n"
        "import nova_tpu_torch.curves.pairing, nova_tpu_torch.provider.ptau\n"
        "import nova_tpu_torch.provider.hyperkzg, nova_tpu_torch.curves.msm_host\n"
        "import nova_tpu_torch.perf.thresholds\n"
        "import nova_tpu_torch.spartan.ppsnark, nova_tpu_torch.spartan.direct\n"
        "import nova_tpu_torch.provider.mercury\n"
        "import nova_tpu_torch.traits, nova_tpu_torch.frontend.uint32\n"
        "import nova_tpu_torch.frontend.sha256, nova_tpu_torch.neutron\n"
        "import nova_tpu_torch.neutron.circuit, nova_tpu_torch.neutron.ivc\n"
        "import nova_tpu_torch.serde, nova_tpu_torch.checkpoint\n"
        "import nova_tpu_torch.ops.msm, nova_tpu_torch.parallel\n"
        "import nova_tpu_torch.graft_entry\n"
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


def test_serde_resolves_no_nova_tpu_module():
    """Bytes naming classes by the JAX package's paths (``nova_tpu.<module>``,
    as both packages write them) load into the port's classes, and no jax
    or nova_tpu module is imported while they do."""
    code = (
        "import sys\n"
        "from nova_tpu_torch import serde\n"
        "from nova_tpu_torch.curves.spec import pallas\n"
        "from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine\n"
        "from nova_tpu_torch.r1cs import R1CSInstance, RelaxedR1CSInstance\n"
        "from nova_tpu_torch.spartan.polys import UniPoly\n"
        "from nova_tpu_torch.fields.spec import pallas_scalar\n"
        "from nova_tpu_torch.curves.spec import AffinePoint\n"
        "c = Commitment(AffinePoint.generator(pallas).mul(5))\n"
        "objs = [RelaxedR1CSInstance(c, c, [1, 2], 3), R1CSInstance(c, [4, 5]),\n"
        "        UniPoly(pallas_scalar, [1, 2, 3]), CommitmentEngine]\n"
        "raw = serde.dumps(objs)\n"
        "assert b'nova_tpu.r1cs:RelaxedR1CSInstance' in raw\n"
        "assert b'nova_tpu_torch' not in raw\n"
        "back = serde.loads(raw)\n"
        "assert serde.dumps(back) == raw and back[3] is CommitmentEngine\n"
        "assert type(back[0]) is RelaxedR1CSInstance and back[0] == objs[0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'nova_tpu')]\n"
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


def test_native_source_is_the_shared_one():
    """The binding builds the repository's native/nova_native.cpp into the
    port's git-ignored build directory, never beside the JAX package."""
    from nova_tpu_torch import native

    assert native.SRC == os.path.join(ROOT, "native", "nova_native.cpp")
    assert native.BUILD_ROOT == os.path.join(PKG, "_build")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert "nova_tpu_torch/_build/" in fh.read().split()


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
    from nova_tpu_torch.ops.sumcheck import DevicePoly
    from nova_tpu_torch.perf import ubench_field

    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePoly(pallas.scalar, [1, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        ubench_field.inputs(8)
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.provider.engines import Bn256EngineIPA, GrumpkinEngine

    with pytest.raises(RuntimeError, match="CUDA"):  # before any file is read
        PublicParams.setup_with_ptau_dir(Bn256EngineIPA, GrumpkinEngine, None, ROOT)
    from nova_tpu_torch import graft_entry
    from nova_tpu_torch.ops.msm import DeviceBases
    from nova_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBases(pallas, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4, devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(4)
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
