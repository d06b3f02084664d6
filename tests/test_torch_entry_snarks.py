"""The port's proving bench twins (``nova_tpu_torch/benches/``:
recursive_snark, compressed_snark, ppsnark) against the JAX package's grids
on the CPU, at their smallest sizes, as tests/test_torch_entry_benches.py
runs them. compressed_snark runs its snark configuration (--quick): its
ppsnark configuration needs 2^17-generator keys, which chip_smoke.py's
phase 10 exercises on the card. Tolerance: exact (config strings, which
carry the constraint counts, digests, outputs equal)."""

import secrets

import pytest
import torch

from nova_tpu.nova.ivc import PublicParams as JPP
from nova_tpu.spartan.direct import DirectSNARK as JDirect

from nova_tpu_torch.benches import compressed_snark, ppsnark, recursive_snark

from tests.test_torch_entry_benches import _key, jax_bench  # noqa: F401
from tests.test_torch_entry_examples import (  # noqa: F401
    checked_keys, jax_keys, jax_spies, seeded)

torch.set_num_threads(1)

SEED = 77


def test_recursive_snark_grid_matches_reference(jax_keys, jax_spies, jax_bench):  # noqa: F811
    """`--sizes 0` (one square): equal config (cons=(primary, secondary))
    and PublicParams digest."""
    jrows, _ = jax_bench("recursive_snark", ["--sizes", "0"])
    rows = recursive_snark.main(["--sizes", "0"], device="cpu")
    assert [_key(r) for r in rows] == [_key(r) for r in jrows]
    assert rows[0]["config"] == "cons=(9819, 10349)"
    assert rows[0]["pp_digest"] == jax_spies["setup"][0].digest()


def test_compressed_snark_grid_matches_reference(jax_keys, jax_spies, jax_bench,  # noqa: F811
                                                 monkeypatch):
    """`--sizes 0 --quick` (the trivial circuit, snark/snark with IPA):
    equal config and digest; the twin's proof verifies to z_n = [0]."""
    seeded(monkeypatch, SEED)
    jrows, _ = jax_bench("compressed_snark", ["--sizes", "0", "--quick"])
    seeded(monkeypatch, SEED)
    rows = compressed_snark.main(["--sizes", "0", "--quick"], device="cpu")
    assert [_key(r) for r in rows] == [_key(r) for r in jrows]
    assert rows[0]["config"] == "snark cons=(9818, 10349)"
    assert rows[0]["zn"] == [0]


def test_ppsnark_grid_matches_reference(jax_keys, jax_bench, monkeypatch):  # noqa: F811
    """`--sizes 4` (DirectSNARK with ppsnark on a 16-square chain): equal
    config and constraint count of the direct circuit's shape (16 squares
    and the two inputized outputs)."""
    shapes = []
    real = JDirect.setup

    def spy(*a, **k):
        pk, vk = real(*a, **k)
        shapes.append(pk.S.num_cons)
        return pk, vk

    monkeypatch.setattr(JDirect, "setup", staticmethod(spy))
    seeded(monkeypatch, SEED)
    jrows, _ = jax_bench("ppsnark", ["--sizes", "4"])
    seeded(monkeypatch, SEED)
    rows = ppsnark.main(["--sizes", "4"], device="cpu")
    assert [_key(r) for r in rows] == [_key(r) for r in jrows]
    assert [r["num_cons"] for r in rows] == shapes == [18]
