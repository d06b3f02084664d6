"""NOVA_LEGACY_MAP=1 in the port's Pedersen engine
(``nova_tpu_torch.provider.pedersen``): the try-and-increment generators of
the JAX package, cached under its ``ck_`` name, and commitments equal to
its own; without the flag the hash-to-curve ``ck2_`` keys are unchanged.

The flag is set with monkeypatch, as tests/test_hash_to_curve.py sets it.
Tolerance: exact (points equal coordinate for coordinate)."""

import os
import random

import pytest
import torch

from nova_tpu.curves.spec import ALL_CURVES as JCURVES
from nova_tpu.provider import pedersen as jpedersen

from nova_tpu_torch.curves.spec import ALL_CURVES
from nova_tpu_torch.provider import pedersen

torch.set_num_threads(1)


def _xy(pts):
    return [(p.x, p.y, p.infinity) for p in pts]


@pytest.mark.parametrize("name", ["pallas", "vesta", "bn254", "grumpkin", "secp256k1"])
def test_legacy_from_label_matches_reference(name, monkeypatch):
    new = _xy(pedersen.from_label(ALL_CURVES[name], b"ck", 3))
    assert new == _xy(jpedersen.from_label(JCURVES[name], b"ck", 3))
    monkeypatch.setenv("NOVA_LEGACY_MAP", "1")
    old = _xy(pedersen.from_label(ALL_CURVES[name], b"ck", 3, workers=4))
    assert old == _xy(jpedersen.from_label(JCURVES[name], b"ck", 3))
    assert old != new
    assert all(p.is_on_curve() for p in pedersen.from_label(ALL_CURVES[name], b"ck", 3))


def test_legacy_map_matches_reference_bytes():
    rng = random.Random(3)
    for name in ("pallas", "bn254"):
        for _ in range(8):
            blk = rng.randbytes(32)
            a = pedersen.map_to_curve_legacy(ALL_CURVES[name], blk)
            b = jpedersen.map_to_curve_legacy(JCURVES[name], blk)
            assert (a.x, a.y) == (b.x, b.y)


def _cache_files(label):
    d = pedersen._KEY_CACHE_DIR
    return sorted(f for f in os.listdir(d) if f"_pallas_{label}_" in f) if os.path.isdir(d) else []


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "hash-to-curve"])
def test_setup_cache_name_and_commit(legacy, monkeypatch):
    """CommitmentEngine.setup under the flag derives and caches the legacy
    key as ``ck_pallas_<label>_17.npy`` (``ck2_`` without the flag), loads
    it back, and commits as the JAX package does."""
    label = f"port-legacy-{'on' if legacy else 'off'}-{os.getpid()}"
    if legacy:
        monkeypatch.setenv("NOVA_LEGACY_MAP", "1")
    tag = "ck" if legacy else "ck2"
    ck = pedersen.CommitmentEngine.setup(ALL_CURVES["pallas"], label.encode(), 16,
                                         device="cpu", workers=1)
    path = os.path.join(pedersen._KEY_CACHE_DIR, f"{tag}_pallas_{label}_17.npy")
    try:
        assert _cache_files(label) == [os.path.basename(path)]
        again = pedersen.CommitmentEngine.setup(ALL_CURVES["pallas"], label.encode(), 16,
                                                device="cpu")
        assert _xy([again.h] + again.ck) == _xy([ck.h] + ck.ck)
        gens = jpedersen.from_label(JCURVES["pallas"], label.encode(), 17)
        assert _xy([ck.h] + ck.ck) == _xy(gens)
        jck = jpedersen.CommitmentKey(JCURVES["pallas"], gens[1:], gens[0])
        v = [random.Random(5).randrange(1 << 200) for _ in range(16)]
        got = pedersen.CommitmentEngine.commit(ck, v, 9).point
        want = jpedersen.CommitmentEngine.commit(jck, v, 9).point
        assert (got.x, got.y) == (want.x, want.y)
    finally:
        os.remove(path)
