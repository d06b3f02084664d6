"""The port's bytes (``nova_tpu_torch.serde``, ``checkpoint``), its Pedersen
methods of the NeutronNova/Spark family and ``profiling.device_trace``
against the JAX package on CPU.

Proofs come from tests/test_torch_ivc.py's cubic circuit, its public
parameters carried across (``interop.public_params``), with
``secrets.randbelow`` patched to one seeded generator in both packages.
Tolerance: exact (bytes equal; points as affine coordinates)."""

import os
import random
import secrets
import subprocess
import sys

import numpy as np
import pytest
import torch

from nova_tpu import checkpoint as jcheckpoint
from nova_tpu import native as jnative
from nova_tpu import serde as jserde
from nova_tpu.curves.spec import AffinePoint as JAffine
from nova_tpu.frontend.constraint_system import ONE as JONE, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import StepCircuit as JStep
from nova_tpu.nova.compressed import CompressedSNARK as JCS
from nova_tpu.nova.ivc import RecursiveSNARK as JRS
from nova_tpu.provider.pedersen import (
    CommitmentEngine as JCE,
    CommitmentKey as JCommitmentKey,
)

from nova_tpu_torch import checkpoint, native, profiling, serde
from nova_tpu_torch.curves.spec import pallas
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.nova.compressed import CompressedSNARK as TCS
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.ops.fvec import as_list
from nova_tpu_torch.provider.engines import PallasEngine as TPE
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

from tests.test_torch_compressed import proof_fields
from tests.test_torch_ivc import cubic, cubic_pp  # noqa: F401  (module fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def _seeded(monkeypatch, seed):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))


def _steps(pp, RS, circuit, steps):
    rs = RS.new(pp, circuit, [2])
    for _ in range(steps):
        rs.prove_step(pp, circuit)
    return rs


@pytest.fixture(scope="module")
def proofs(cubic_pp):  # noqa: F811
    """The same CompressedSNARK proved by each package, and its verifier
    keys: (jax proof, jax vk, port proof, port vk)."""
    jpp, tpp = cubic_pp
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for pp, RS, CS, circuit in ((jpp, JRS, JCS, cubic(JStep, JNum, JONE, jlc)),
                                    (tpp, TRS, TCS, cubic(TStep, TNum, TONE, tlc))):
            _seeded(mp, 41)
            rs = _steps(pp, RS, circuit, STEPS)
            pk, vk = CS.setup(pp)
            out += [CS.prove(pp, pk, rs), vk]
    return out


def test_proof_bytes_equal_reference(proofs):
    j, jvk, t, tvk = proofs
    assert proof_fields(t) == proof_fields(j)
    assert serde.dumps(t) == jserde.dumps(j)
    assert serde.dumps_evm(t) == jserde.dumps_evm(j)
    assert checkpoint.proof_to_bytes(t) == jcheckpoint.proof_to_bytes(j)


def test_key_bytes_equal_reference(proofs):
    """The verifier key (its commitment keys hold a device in the port,
    which serde leaves out) is written as the JAX package writes it, and
    the JAX package's key bytes load into the port's classes and write the
    same bytes again. (A key read back lacks its digest cache in both
    packages, so neither verifies with it.)"""
    j, jvk, t, tvk = proofs
    raw = jserde.dumps(jvk)
    assert serde.dumps(tvk) == raw
    back = serde.loads(raw)
    assert type(back) is type(tvk) and back.vk_secondary.ee_vk.ck_v.device is None
    assert back.vk_primary.ee_vk.ck_v.ck == tvk.vk_primary.ee_vk.ck_v.ck
    assert serde.dumps(back) == raw


def test_proofs_cross_load(proofs):
    j, jvk, t, tvk = proofs
    z = t.verify(tvk, STEPS, [2])
    # the JAX package's bytes into the port, and the port's into the JAX package
    from_j = checkpoint.proof_from_bytes(jcheckpoint.proof_to_bytes(j))
    assert type(from_j) is TCS and from_j.verify(tvk, STEPS, [2]) == z
    from_t = jcheckpoint.proof_from_bytes(checkpoint.proof_to_bytes(t))
    assert type(from_t) is JCS and from_t.verify(jvk, STEPS, [2]) == z
    evm = serde.loads_evm(jserde.dumps_evm(j))
    assert evm.verify(tvk, STEPS, [2]) == z and serde.dumps_evm(evm) == jserde.dumps_evm(j)
    # a flipped byte inside a point's x coordinate: the point fails its
    # on-curve check at load
    raw = bytearray(checkpoint.proof_to_bytes(t))
    tag = b"PS" + len(b"pallas").to_bytes(4, "big") + b"pallas"
    raw[raw.index(tag) + len(tag) + 1 + 5 + 3] ^= 1
    with pytest.raises(NovaError, match="invalid point"):
        checkpoint.proof_from_bytes(bytes(raw))


def _obj_bytes(path: str) -> bytes:
    """An object of class path `path` with no fields, in the byte format."""
    out = bytearray(b"O")
    raw = path.encode()
    out += b"S" + len(raw).to_bytes(4, "big") + raw
    out += b"D" + (0).to_bytes(4, "big")
    return bytes(out)


@pytest.mark.parametrize("path", [
    "os:system", "subprocess:Popen", "nova_tpu_torch.serde:NovaError",
    "nova_tpu_torch_evil.x:Y", "nova_tpu:Engine", "nova_tpu.:X", "nova_tpu.a..b:X",
    "nova_tpu.ops.fvec:FVec.x", "nova_tpu.__main__:X", "nova_tpu.no_such_module:X",
    "nova_tpu.provider.engines:no_such_class", "nova_tpu.provider.engines:np",
])
def test_foreign_class_paths_refused(path):
    before = set(sys.modules)
    with pytest.raises(NovaError):
        serde.loads(_obj_bytes(path))
    with pytest.raises(NovaError):
        serde.loads(b"K" + _obj_bytes(path)[1:-5])
    assert set(sys.modules) - before == set()


def test_loads_resolves_no_reference_module(proofs):
    """In a process that imports only the port, loading the JAX package's
    bytes (a CompressedSNARK naming the classes of several modules) imports
    neither jax nor any nova_tpu module."""
    j = proofs[0]
    code = (
        "import sys\n"
        "from nova_tpu_torch import checkpoint\n"
        "proof = checkpoint.proof_from_bytes(sys.stdin.buffer.read())\n"
        "assert type(proof).__module__ == 'nova_tpu_torch.nova.compressed'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'nova_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], input=jcheckpoint.proof_to_bytes(j), cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=300,
    )
    assert out.returncode == 0 and b"clean" in out.stdout, out.stdout


def _state(rs):
    return {
        "i": rs.i, "zi": list(rs.zi), "ri": (rs.ri_primary, rs.ri_secondary),
        "U": [(U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)
              for U in (rs.r_U_primary, rs.r_U_secondary)],
        "W": [(as_list(W.W), as_list(W.E), W.r_W, W.r_E)
              for W in (rs.r_W_primary, rs.r_W_secondary)],
        "l_u": (rs.l_u_secondary.comm_W.to_coordinates(), list(rs.l_u_secondary.X)),
        "l_w": (as_list(rs.l_w_secondary.W), rs.l_w_secondary.r_W),
    }


def test_checkpoint_resume_equals_unbroken_run(cubic_pp, tmp_path, monkeypatch):  # noqa: F811
    """Save after two steps, load under the same pp and prove one more step;
    the same step on the unbroken object with the same randomness gives the
    same state. The port's checkpoint bytes are the JAX package's, and a
    JAX checkpoint resumes in the port."""
    jpp, tpp = cubic_pp
    tc, jc = cubic(TStep, TNum, TONE, tlc), cubic(JStep, JNum, JONE, jlc)
    _seeded(monkeypatch, 43)
    t = _steps(tpp, TRS, tc, STEPS)
    _seeded(monkeypatch, 43)
    j = _steps(jpp, JRS, jc, STEPS)
    path, jpath = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    checkpoint.save_recursive_snark(path, tpp, t)
    jcheckpoint.save_recursive_snark(jpath, jpp, j)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    resumed = checkpoint.load_recursive_snark(path, tpp)
    from_jax = checkpoint.load_recursive_snark(jpath, tpp)
    assert resumed._wgen_primary is None and _state(resumed) == _state(t)
    for rs in (t, resumed, from_jax):
        _seeded(monkeypatch, 47)
        rs.prove_step(tpp, tc)
    assert _state(resumed) == _state(t) == _state(from_jax)
    assert resumed.verify(tpp, STEPS + 1, [2]) == t.verify(tpp, STEPS + 1, [2])

    class OtherPP:
        def digest(self):
            return tpp.digest() + 1

    with pytest.raises(NovaError):
        checkpoint.load_recursive_snark(path, OtherPP())


def test_ck_save_load_matches_reference(tmp_path):
    tck = TCE.setup(pallas, b"serde-test", 16, device="cpu", workers=1)
    jck = JCommitmentKey(
        jpallas(), [JAffine(jpallas(), g.x, g.y, g.infinity) for g in tck.ck],
        JAffine(jpallas(), tck.h.x, tck.h.y, tck.h.infinity))
    path, jpath = str(tmp_path / "t.key"), str(tmp_path / "j.key")
    checkpoint.save_ck(path, tck)
    jcheckpoint.save_ck(jpath, jck)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    back = checkpoint.load_ck(jpath, pallas, device="cpu")
    assert back.ck == tck.ck and back.h == tck.h and back.device.type == "cpu"
    raw = bytearray(open(path, "rb").read())
    raw[len(b"PEDERSEN_KEY") + 8 + 5] ^= 1
    with open(path, "wb") as fh:
        fh.write(raw)
    with pytest.raises(NovaError):
        checkpoint.load_ck(path, pallas, device="cpu")


def jpallas():
    from nova_tpu.curves.spec import pallas as jp

    return jp


@pytest.mark.parametrize("binding", [True, False], ids=["native", "no-binding"])
def test_pedersen_methods_match_reference(binding, monkeypatch):
    """batch_commit_small, commit_small_range, ck_derive_by_address,
    commit_sparse and commit_sparse_binary on a 64-generator key, with the
    native binding and with both packages' binding reported unavailable."""
    if not binding:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    tck = TCE.setup(pallas, b"serde-test", 64, device="cpu", workers=1)
    jp = jpallas()
    jck = JCommitmentKey(jp, [JAffine(jp, g.x, g.y, g.infinity) for g in tck.ck],
                         JAffine(jp, tck.h.x, tck.h.y, tck.h.infinity))
    rng = np.random.default_rng(53)
    p = pallas.scalar.p

    def xy(c):
        return c.to_coordinates()

    vs = [[int(x) for x in rng.integers(0, 1 << 20, n)] for n in (5, 17, 40)]
    rs = [0, 7, int(rng.integers(1, 1 << 62))]
    assert ([xy(c) for c in TCE.batch_commit_small(tck, vs, rs)]
            == [xy(c) for c in JCE.batch_commit_small(jck, vs, rs)])
    for v, rng_, r in ((vs[1], range(10, 40), 3), ([], range(0, 4), 5),
                       (vs[0], range(59, 64), 0)):
        assert (xy(TCE.commit_small_range(tck, v, r, rng_, 20))
                == xy(JCE.commit_small_range(jck, v, r, rng_, 20)))
    addr = [int(a) for a in rng.integers(0, 12, 48)]
    tder, jder = TCE.ck_derive_by_address(tck, addr, 16), JCE.ck_derive_by_address(jck, addr, 16)
    assert [xy(g) for g in tder.ck] == [(g.x, g.y, g.infinity) for g in jder.ck]
    assert tder.h == tck.h and tder.device == tck.device
    with pytest.raises(NovaError):
        TCE.ck_derive_by_address(tck, [16], 16)
    with pytest.raises(NovaError):
        TCE.ck_derive_by_address(tck, [0] * 65, 16)
    idx = sorted(int(i) for i in rng.choice(64, 20, replace=False))
    sc = [int.from_bytes(rng.bytes(32), "little") % p for _ in idx]
    for r in (0, 11):
        assert xy(TCE.commit_sparse(tck, idx, sc, r)) == xy(JCE.commit_sparse(jck, idx, sc, r))
        assert (xy(TCE.commit_sparse_binary(tck, idx, r))
                == xy(JCE.commit_sparse_binary(jck, idx, r)))
    assert xy(TCE.commit_sparse(tck, [], [], 0)) == xy(JCE.commit_sparse(jck, [], [], 0))
    assert xy(TCE.commit_sparse_binary(tck, [], 9)) == xy(JCE.commit_sparse_binary(jck, [], 9))


def test_device_trace_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.device_trace(d):
        torch.arange(64).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0
