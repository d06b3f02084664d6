"""The port's example twins (``nova_tpu_torch/examples/``: minroot,
and_example, hashchain) against the JAX package's scripts
(``examples/*.py``) on the CPU.

Each JAX script's own ``main`` runs with its argv patched, and spies on
its PublicParams.setup, RecursiveSNARK.verify and CompressedSNARK.prove
keep what it computed; the twin's ``main`` runs with ``device="cpu"``. The
JAX package's commitment keys are built from the generators the port
derives in a process pool and caches (the JAX package derives them
serially in pure Python; tests/test_torch_host.py holds the two
derivations equal on 32 generators, and the fixture holds each key it
serves against the JAX derivation at 65 indices across it). Randomness: ``secrets.randbelow`` is patched to one
seeded generator, restarted from the same seed for each package; the
operands of and_example come from random.Random(SEED) in both. Tolerance:
exact (z_n, PublicParams digests and compressed-proof bytes equal)."""

import importlib.util
import os
import random
import secrets
import sys

import pytest
import torch

from nova_tpu import checkpoint as jcheckpoint
from nova_tpu.curves.spec import AffinePoint as JAffine
from nova_tpu.nova.compressed import CompressedSNARK as JCS
from nova_tpu.nova.ivc import PublicParams as JPP, RecursiveSNARK as JRS
from nova_tpu.provider import pedersen as jpedersen

from nova_tpu_torch import checkpoint
from nova_tpu_torch.curves.spec import ALL_CURVES as TCURVES
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.examples import and_example, hashchain, minroot
from nova_tpu_torch.frontend.constraint_system import ShapeCS
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1212


def load_script(rel_path: str, name: str):
    """A JAX entry script of the repository loaded as a module (its import
    pins JAX to the CPU, as JAX_PLATFORMS=cpu asks)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_derivation_at(curve, label, n, indices) -> dict:
    """{i: generator i} of the JAX package's own from_label(curve, label,
    n) (its XOF and block order), the map to the curve run only at
    `indices`."""
    from nova_tpu.provider import hash_to_curve as jh2c

    want, count = {}, iter(range(n))

    def at(real):
        def sampled(*a):
            i = next(count)
            if i in indices:
                want[i] = real(*a)
            return None

        return sampled

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jh2c, "hash_to_curve", at(jh2c.hash_to_curve))
        m.setattr(jpedersen, "map_to_curve_legacy", at(jpedersen.map_to_curve_legacy))
        jpedersen.from_label(curve, label, n)
    return want


@pytest.fixture(scope="session")
def checked_keys():
    """(curve, label, count) of the keys jax_keys has held against the JAX
    derivation in this session."""
    return set()


@pytest.fixture
def jax_keys(monkeypatch, checked_keys):
    """The JAX package's CommitmentEngine.setup serving the port's cached
    generators (same label, same count). Each key served is first held
    against the JAX package's own derivation at 64 indices spread over the
    whole key and at its last index (tests/test_torch_host.py holds the
    first 32 generators)."""

    def setup(curve, label, n):
        tck = TCE.setup(TCURVES[curve.name], label, n, device="cpu")
        gens = [tck.h] + tck.ck
        if (curve.name, label, len(gens)) not in checked_keys:
            idx = set(range(0, len(gens), max(1, len(gens) // 64))) | {len(gens) - 1}
            want = jax_derivation_at(curve, label, len(gens), idx)
            assert sorted(want) == sorted(idx)
            for i, g in want.items():
                assert (gens[i].x, gens[i].y, gens[i].infinity) == (g.x, g.y, g.infinity), i
            checked_keys.add((curve.name, label, len(gens)))
        conv = [JAffine(curve, g.x, g.y, g.infinity) for g in gens]
        return jpedersen.CommitmentKey(curve, conv[1:], conv[0])

    monkeypatch.setattr(jpedersen.CommitmentEngine, "setup", staticmethod(setup))


def seeded(monkeypatch, seed):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))


@pytest.fixture
def jax_spies(monkeypatch):
    """{name: [results]} of the JAX package's PublicParams.setup,
    RecursiveSNARK.verify and CompressedSNARK.prove while the test runs."""
    seen = {}

    def spy(owner, name, bound):
        real = getattr(owner, name)

        def wrapper(*a, **k):
            out = real(*a, **k)
            seen.setdefault(name, []).append(out)
            return out

        monkeypatch.setattr(owner, name, wrapper if bound else staticmethod(wrapper))

    spy(JPP, "setup", False)
    spy(JRS, "verify", True)
    spy(JCS, "prove", False)
    return seen


def test_minroot_matches_reference(jax_keys, jax_spies, monkeypatch, capsys):
    """MinRoot at 4 iterations x 2 steps: equal z_n, PublicParams digest and
    compressed-proof bytes; the docstring's 3 constraints an iteration; a
    wrong z0 fails the compressed proof."""
    jmod = load_script("examples/minroot.py", "jax_minroot")
    monkeypatch.setattr(sys, "argv", ["minroot.py", "4", "2"])
    seeded(monkeypatch, SEED)
    jmod.main()
    seeded(monkeypatch, SEED)
    out = minroot.main(["4", "2"], device="cpu")
    assert "OK" in capsys.readouterr().out
    jpp = jax_spies["setup"][0]
    assert out["pp"].digest() == jpp.digest()
    assert out["pp"].num_constraints() == jpp.num_constraints()
    assert out["zn"] == jax_spies["verify"][0]
    assert checkpoint.proof_to_bytes(out["proof"]) == jcheckpoint.proof_to_bytes(
        jax_spies["prove"][0])
    # 3 constraints an iteration: 4 more iterations add 12
    counts = []
    for iters in (4, 8):
        cs = ShapeCS(TCURVES["pallas"].scalar)
        _, seq = minroot.MinRootIteration.seq(TCURVES["pallas"].scalar, iters, 2, 3)
        minroot.MinRootCircuit(seq).synthesize(
            cs, [AllocatedNum.alloc(cs, 2), AllocatedNum.alloc(cs, 3)])
        counts.append(cs.num_constraints())
    assert counts[1] - counts[0] == 12
    with pytest.raises(NovaError):
        out["proof"].verify(out["vk"], 2, [3, 3])


def test_and_example_matches_reference(jax_keys, jax_spies, monkeypatch):
    """One AND a step, 2 steps, operands from random.Random(SEED) in both
    packages: equal z_n and PublicParams digest."""
    jmod = load_script("examples/and_example.py", "jax_and_example")
    monkeypatch.setattr(jmod, "rng", random.Random(SEED))
    monkeypatch.setattr(sys, "argv", ["and_example.py", "1", "2"])
    seeded(monkeypatch, SEED)
    jmod.main()
    seeded(monkeypatch, SEED)
    out = and_example.main(["1", "2"], device="cpu", seed=SEED)
    assert out["pp"].digest() == jax_spies["setup"][0].digest()
    assert out["zn"] == jax_spies["verify"][0] == [0]


def test_hashchain_matches_reference(jax_keys, jax_spies, monkeypatch):
    """Two elements a step, 2 steps, elements from random.Random(0xC4A1) in
    both packages: equal z_n (the native recomputation, checked by both
    scripts) and PublicParams digest."""
    jmod = load_script("examples/hashchain.py", "jax_hashchain")
    monkeypatch.setattr(jmod, "rng", random.Random(hashchain.SEED))
    monkeypatch.setattr(sys, "argv", ["hashchain.py", "2", "2"])
    seeded(monkeypatch, SEED)
    jmod.main()
    seeded(monkeypatch, SEED)
    out = hashchain.main(["2", "2"], device="cpu")
    assert out["pp"].digest() == jax_spies["setup"][0].digest()
    assert out["zn"] == jax_spies["verify"][0]
