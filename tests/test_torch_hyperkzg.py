"""The port's BN254 pairing, ptau files and HyperKZG evaluation engine
(``nova_tpu_torch.curves.pairing``, ``provider.ptau``,
``provider.hyperkzg``) against the JAX package on CPU, mirroring
tests/test_hyperkzg.py at small sizes: a 2^4 ptau file, 32- and 16-entry
polynomials. Inputs come from numpy seeds. Tolerance: exact (pairing values
equal, file bytes equal, points as affine coordinates, proofs field by
field)."""

import numpy as np
import pytest
import torch

from nova_tpu.curves import pairing as jpairing
from nova_tpu.curves.spec import AffinePoint as JA, bn254 as JBN
from nova_tpu.provider import hyperkzg as jkzg, ptau as jptau
from nova_tpu.provider.engines import Bn256EngineKZG as JE
from nova_tpu.provider.pedersen import CommitmentEngine as JCE
from nova_tpu.spartan.polys import MultilinearPolynomial as JML

from nova_tpu_torch import native as tn
from nova_tpu_torch.curves.pairing import (
    F12_ONE,
    G2Point,
    f12_pow,
    multi_pairing_is_one,
    pairing,
)
from nova_tpu_torch.curves.spec import AffinePoint, bn254
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.provider import hyperkzg as tkzg, ptau as tptau
from nova_tpu_torch.provider.engines import Bn256EngineKZG as TE
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE
from nova_tpu_torch.spartan.polys import MultilinearPolynomial as TML

torch.set_num_threads(1)

R = bn254.scalar.p


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _xy(points):
    return [q.to_coordinates() for q in points]


def test_pairing_bilinearity():
    g1 = AffinePoint.generator(bn254)
    g2 = G2Point.generator()
    e = pairing(g1, g2)
    assert e != F12_ONE
    assert pairing(g1.double(), g2) == f12_pow(e, 2)
    assert pairing(g1, g2.double()) == f12_pow(e, 2)
    a, b = 1234, 5678
    assert pairing(g1.mul(a), g2.mul(b)) == f12_pow(e, a * b)
    assert f12_pow(e, R) == F12_ONE
    assert multi_pairing_is_one([(g1, g2), (g1.neg(), g2)])
    assert not multi_pairing_is_one([(g1, g2), (g1, g2)])
    # the same value as the JAX package's pairing
    jg1 = JA.generator(JBN).mul(a)
    assert pairing(g1.mul(a), g2.mul(b)) == jpairing.pairing(jg1, jpairing.G2Point.generator().mul(b))


def test_test_ptau_bytes_and_cross_read(tmp_path):
    """write_test_ptau writes the JAX writer's bytes; each package reads the
    other's file to the same points."""
    tau = _rand(np.random.default_rng(1), 1)[0]
    tp, jp = tmp_path / "t" / "ppot_pruned_04.ptau", tmp_path / "j" / "ppot_pruned_04.ptau"
    tp.parent.mkdir()
    jp.parent.mkdir()
    tptau.write_test_ptau(str(tp), tau, 4)
    jptau.write_test_ptau(str(jp), tau, 4)
    assert tp.read_bytes() == jp.read_bytes()
    with open(jp, "rb") as fh:
        g1, g2 = tptau.read_ptau(fh, 17, 2)
    with open(tp, "rb") as fh:
        jg1, jg2 = jptau.read_ptau(fh, 17, 2)
    assert _xy(g1) == _xy(jg1)
    assert [(q.x, q.y) for q in g2] == [(q.x, q.y) for q in jg2]
    assert g1[1] == AffinePoint.generator(bn254).mul(tau)
    tptau.check_sanity_of_ptau_file(str(tp), 16, 2)
    with pytest.raises(NovaError):
        tptau.check_sanity_of_ptau_file(str(tp), 1 << 10, 2)  # too many G1 points
    assert tptau.find_ptau_file(str(tp.parent), 10) == str(tp)
    assert tptau.find_ptau_file(str(tp.parent), 1 << 10) is None
    pruned = tmp_path / "t" / "ppot_pruned_03.ptau"
    tptau.prune_ptau(str(tp), str(pruned), 3)
    jpruned = tmp_path / "j" / "ppot_pruned_03.ptau"
    jptau.prune_ptau(str(jp), str(jpruned), 3)
    assert pruned.read_bytes() == jpruned.read_bytes()
    # a corrupted G1 point is refused
    raw = bytearray(tp.read_bytes())
    g1_start = len(raw) - (12 + 2 * 128) - 17 * 64  # G1 payload, then section 3
    raw[g1_start + 64 + 5] ^= 1  # a byte of the second G1 point's x
    bad = tmp_path / "bad.ptau"
    bad.write_bytes(bytes(raw))
    with open(bad, "rb") as fh, pytest.raises(NovaError):
        tptau.read_ptau(fh, 17, 2)


def test_load_ck_from_ptau_matches(tmp_path):
    tau = _rand(np.random.default_rng(2), 1)[0]
    path = str(tmp_path / "ppot_pruned_04.ptau")
    jptau.write_test_ptau(path, tau, 4)
    ck = tptau.load_ck_from_ptau(path, 13, device="cpu")
    jck = jptau.load_ck_from_ptau(path, 13)
    assert len(ck.ck) == len(jck.ck) == 16
    assert _xy(ck.ck) == _xy(jck.ck)
    assert ck.h.to_coordinates() == jck.h.to_coordinates()
    tau_H = G2Point.generator().mul(tau)
    assert (ck._tau_H.x, ck._tau_H.y) == (jck._tau_H.x, jck._tau_H.y) == (tau_H.x, tau_H.y)
    assert ck.device == "cpu"


def _kzg_fields(arg):
    return (_xy(c.point for c in arg.com), _xy(c.point for c in arg.w),
            [list(row) for row in arg.v])


@pytest.mark.parametrize("n,route", [(32, "native"), (32, "python"), (16, "native")])
def test_hyperkzg_proof_matches(monkeypatch, n, route):
    """A HyperKZG proof of the port (its native prover, or its Python one
    with the binding patched away) equals the JAX package's field by field,
    verifies, and fails with a changed evaluation, fold value or witness."""
    rng = np.random.default_rng(3 + n)
    tau = _rand(rng, 1)[0]
    ck, tau_H = tkzg.setup_from_tau(tau, n, device="cpu")
    jck, jtau_H = jkzg.setup_from_tau(tau, n)
    assert _xy(ck.ck) == _xy(jck.ck) and (tau_H.x, tau_H.y) == (jtau_H.x, jtau_H.y)
    ell = n.bit_length() - 1
    poly, point = _rand(rng, n), _rand(rng, ell)
    ev = TML.evaluate_with(TE.scalar, poly, point)
    assert ev == JML.evaluate_with(JE.scalar, poly, point)
    comm, jcomm = TCE.commit(ck, poly, 0), JCE.commit(jck, poly, 0)
    assert comm.point.to_coordinates() == jcomm.point.to_coordinates()
    jpk, jvk = jkzg.EvaluationEngine.setup(JE, jck)
    want = jkzg.EvaluationEngine.prove(JE, jck, jpk, JE.new_transcript(b"hkzg"), jcomm, poly,
                                       point, ev)
    if route == "python":
        monkeypatch.setattr(tn, "available", lambda: False)
    pk, vk = tkzg.EvaluationEngine.setup(TE, ck)
    arg = tkzg.EvaluationEngine.prove(TE, ck, pk, TE.new_transcript(b"hkzg"), comm, poly,
                                      point, ev)
    assert _kzg_fields(arg) == _kzg_fields(want)
    tkzg.EvaluationEngine.verify(TE, vk, TE.new_transcript(b"hkzg"), comm, point, ev, arg)
    with pytest.raises(NovaError):
        tkzg.EvaluationEngine.verify(TE, vk, TE.new_transcript(b"hkzg"), comm, point,
                                     (ev + 1) % R, arg)
    arg.v[0][0] = (arg.v[0][0] + 1) % R
    with pytest.raises(NovaError):
        tkzg.EvaluationEngine.verify(TE, vk, TE.new_transcript(b"hkzg"), comm, point, ev, arg)
    arg.v[0][0] = (arg.v[0][0] - 1) % R
    arg.w[1] = arg.w[1] + arg.w[0]
    with pytest.raises(NovaError):
        tkzg.EvaluationEngine.verify(TE, vk, TE.new_transcript(b"hkzg"), comm, point, ev, arg)


def test_setup_needs_tau_H():
    from nova_tpu_torch.provider.pedersen import CommitmentKey

    g = AffinePoint.generator(bn254)
    with pytest.raises(NovaError, match="tau_H"):
        tkzg.EvaluationEngine.setup(TE, CommitmentKey(bn254, [g, g.double()], g))
