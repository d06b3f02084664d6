"""The port's bench-grid twins (``nova_tpu_torch/benches/``) against the
JAX package's grids (``benches/*.py``) on the CPU, at their smallest sizes.

Each JAX grid's own ``main`` runs with its argv patched (its rows read
from its output, spies keeping what it computed); each twin's ``main``
runs with ``device="cpu"`` and returns its rows. The JAX package's keys
come from the port's cached generators
(tests/test_torch_entry_examples.py::jax_keys). Tolerance: exact (config
strings, constraint counts, commitments, digests, proofs equal)."""

import json
import os
import sys

import pytest
import torch

from nova_tpu.provider.engines import PallasEngine as JPE, VestaEngine as JVE
from nova_tpu.nova.ivc import PublicParams as JPP
from nova_tpu.provider.keccak import Keccak256Transcript as JTranscript
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
from nova_tpu.spartan.polys import EqPolynomial as JEq, MultilinearPolynomial as JML
from nova_tpu.spartan.sumcheck import SumcheckProof as JSumcheck

from nova_tpu_torch.benches import commit, common, sha256, sumcheckeq

from tests.test_torch_entry_examples import (  # noqa: F401
    ROOT, checked_keys, jax_keys, load_script)

torch.set_num_threads(1)


@pytest.fixture
def jax_bench(monkeypatch, capsys):
    """run(name, argv) -> the JSON rows the JAX grid benches/<name>.py
    prints (its directory on sys.path, as when it is run as a script)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benches"))

    def run(name, argv):
        mod = load_script(f"benches/{name}.py", f"jax_bench_{name}")
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        capsys.readouterr()
        mod.main()
        return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")], mod

    return run


def _key(row):
    return {k: row[k] for k in ("bench", "config")}


def test_common_parse_args_and_rng():
    assert common.parse_args([16, 18, 20], [])[0] == [16, 18, 20]
    assert common.parse_args([16, 18, 20], ["--quick"])[0] == [16]
    assert common.parse_args([16, 18, 20], ["--sizes", "10,12"])[0] == [10, 12]
    assert common.rng().random() == common.rng(0xBE2C).random()


def test_commit_grid_matches_reference(jax_bench, monkeypatch):
    """`--sizes 10`: the six widths' configs and commitments equal (the JAX
    grid's commitments read by a spy on its CommitmentEngine.commit, whose
    first call of each config is the warm-up on the same vector)."""
    seen = []
    real = JCE.commit

    def spy(ck, v, r=0):
        out = real(ck, v, r)
        seen.append(out.to_coordinates())
        return out

    monkeypatch.setattr(JCE, "commit", staticmethod(spy))
    jrows, _ = jax_bench("commit", ["--sizes", "10"])
    rows = commit.main(["--sizes", "10"], device="cpu")
    assert [_key(r) for r in rows] == [_key(r) for r in jrows]
    assert [r["config"] for r in rows] == [f"2^10/u{b}" for b in commit.WIDTHS]
    assert [r["commitment"] for r in rows] == seen[0::2]


@pytest.mark.parametrize("gruen", [True, False], ids=["gruen", "no_gruen"])
def test_sumcheckeq_matches_reference(jax_bench, monkeypatch, gruen):
    """`--sizes 10`: equal configs, and the twin's proofs (Gruen, the
    materialized eq, the device-resident prover; equal among themselves)
    equal to the JAX prover's on the same seeded tables, with the Gruen
    rounds on and with NOVA_NO_GRUEN=1."""
    jrows, _ = jax_bench("sumcheckeq", ["--sizes", "10"])
    rows = sumcheckeq.main(["--sizes", "10"], device="cpu")
    assert [_key(r) for r in rows] == [_key(r) for r in jrows]
    f = JPE.scalar
    r = common.rng()
    n = 1 << 10
    Az, Bz, Cz = ([r.randrange(f.p) for _ in range(n)] for _ in range(3))
    taus = [r.randrange(1, f.p) for _ in range(10)]
    eq = JEq.evals_from_points(f, taus)
    claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, Az, Bz, Cz)) % f.p
    if not gruen:
        monkeypatch.setenv("NOVA_NO_GRUEN", "1")
    ref = JSumcheck.prove_cubic_with_three_inputs(
        f, claim, taus, JML(f, Az), JML(f, Bz), JML(f, Cz), JTranscript(b"b", f))
    want = sumcheckeq.proof_values(ref)
    proofs = rows[0]["proofs"]
    assert proofs["gruen"] == proofs["materialized"] == proofs["device"] == want


def test_sha256_pp_matches_reference(jax_keys, monkeypatch):  # noqa: F811
    """`--sizes 64` without proving: the 64-byte message's PublicParams
    digest and constraint counts (the row's "constraints": 55,204) equal
    those of the JAX grid's circuit."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benches"))
    jmod = load_script("benches/sha256.py", "jax_bench_sha256")
    jpp = JPP.setup(JPE, JVE, jmod.Sha256Circuit(64))
    pp = sha256.public_params(64, "cpu")
    assert pp.num_constraints() == jpp.num_constraints()
    assert pp.num_constraints()[0] == 55204
    assert pp.digest() == jpp.digest()
