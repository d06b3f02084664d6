"""The port's BN254/Grumpkin IVC with HyperKZG compression
(``PublicParams.setup_with_ptau_dir``, ``RecursiveSNARK``,
``CompressedSNARK`` with the HyperKZG engine on the primary and IPA on the
secondary) against the JAX package on CPU, mirroring
tests/test_ivc_matrix.py::test_ivc_with_hyperkzg_compression on the cubic
circuit with a 2^14 test ptau file written from a seeded tau.

The JAX package's PublicParams are built through its own constructor from
its own shapes, its ptau-loaded primary key and the Grumpkin generators the
port derives (tests/test_torch_ivc.py does the same for Pallas/Vesta).
Randomness: ``secrets.randbelow`` is patched to one seeded generator,
restarted from the same seed for each package. Tolerance: exact (digests,
every proof field; commitments as affine points)."""

import random
import secrets

import numpy as np
import pytest
import torch

from nova_tpu.curves.spec import AffinePoint as JAffine
from nova_tpu.frontend.constraint_system import ONE as JONE, ShapeCS as JShapeCS, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import NovaAugmentedCircuit as JAug
from nova_tpu.nova.circuit import StepCircuit as JStep, TrivialCircuit as JTrivial
from nova_tpu.nova.compressed import CompressedSNARK as JCS
from nova_tpu.nova.ivc import PublicParams as JPP, RecursiveSNARK as JRS
from nova_tpu.provider import ptau as jptau
from nova_tpu.provider.engines import Bn256EngineIPA as JBN, GrumpkinEngine as JGR
from nova_tpu.provider.hyperkzg import EvaluationEngine as JKZG
from nova_tpu.provider.pedersen import CommitmentKey as JCommitmentKey
from nova_tpu.provider.poseidon import PoseidonROConstants as JROC

from nova_tpu_torch import interop
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.nova.compressed import CompressedSNARK as TCS
from nova_tpu_torch.nova.ivc import PublicParams as TPP, RecursiveSNARK as TRS
from nova_tpu_torch.provider.engines import Bn256EngineIPA as TBN, GrumpkinEngine as TGR
from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as TKZG

from tests.test_torch_compressed import _relaxed
from tests.test_torch_fold import key_rows, shape_arrays
from tests.test_torch_ivc import augmented_shapes, cubic
from tests.test_torch_spartan import _polys, _pt

torch.set_num_threads(1)

STEPS = 2
POWER = 14  # the cubic circuit's BN254 primary pads to 2^14


@pytest.fixture(scope="module")
def kzg_pp(tmp_path_factory):
    """(the JAX package's pp, the port's setup_with_ptau_dir pp, the ptau
    directory)."""
    d = tmp_path_factory.mktemp("ptau")
    tau = int.from_bytes(np.random.default_rng(17).bytes(32), "little") % JBN.scalar.p
    path = str(d / f"ppot_pruned_{POWER:02d}.ptau")
    jptau.write_test_ptau(path, tau, POWER)
    tpp = TPP.setup_with_ptau_dir(TBN, TGR, cubic(TStep, TNum, TONE, tlc), str(d),
                                  device="cpu")
    S1, S2 = augmented_shapes(
        (JShapeCS, JAug, JTrivial, JROC, (JBN, JGR)), cubic(JStep, JNum, JONE, jlc))
    ck1 = jptau.load_ck_from_ptau(path, max(S1.num_cons, S1.num_vars))
    g2 = [JAffine(JGR.curve, g.x, g.y, g.infinity)
          for g in [tpp.ck_secondary.h] + tpp.ck_secondary.ck]
    jpp = JPP(JBN, JGR, 1, S1, ck1, S2, JCommitmentKey(JGR.curve, g2[1:], g2[0]))
    jpp.digest()
    return jpp, tpp, str(d)


def test_setup_with_ptau_dir_matches_reference(kzg_pp):
    jpp, tpp, d = kzg_pp
    assert tpp.digest() == jpp.digest()
    assert tpp.num_constraints() == jpp.num_constraints()
    assert len(tpp.ck_primary.ck) == 1 << POWER
    assert [g.to_coordinates() for g in tpp.ck_primary.ck] == [
        g.to_coordinates() for g in jpp.ck_primary.ck]
    assert (tpp.ck_primary._tau_H.x, tpp.ck_primary._tau_H.y) == (
        jpp.ck_primary._tau_H.x, jpp.ck_primary._tau_H.y)
    assert tpp.ck_primary.device.type == tpp.ck_secondary.device.type == "cpu"
    # the JAX package's KZG key carried across (interop) gives the same pp
    tau_H = jpp.ck_primary._tau_H
    carried = interop.public_params(
        TBN, TGR, 1, shape_arrays(jpp.r1cs_shape_primary), key_rows(jpp.ck_primary),
        shape_arrays(jpp.r1cs_shape_secondary), key_rows(jpp.ck_secondary),
        device="cpu", tau_H1=(tau_H.x, tau_H.y))
    assert carried.digest() == jpp.digest()
    assert (carried.ck_primary._tau_H.x, carried.ck_primary._tau_H.y) == (tau_H.x, tau_H.y)
    with pytest.raises(NovaError, match="large enough"):
        TPP.setup_with_ptau_dir(TBN, TGR, cubic(TStep, TNum, TONE, tlc), d,
                                ck_hint1=1 << (POWER + 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TPP.setup_with_ptau_dir(TBN, TGR, cubic(TStep, TNum, TONE, tlc), d)


def _compress(pp, RS, CS, KZG, circuit, seed, monkeypatch):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    rs = RS.new(pp, circuit, [2])
    for _ in range(STEPS):
        rs.prove_step(pp, circuit)
    zi = rs.verify(pp, STEPS, [2])
    pk, vk = CS.setup(pp, ee1=KZG)
    return CS.prove(pp, pk, rs), vk, zi


def _kzg_arg_fields(a):
    """Every field of a HyperKZG EvaluationArgument."""
    return ([_pt(c) for c in a.com], [_pt(c) for c in a.w], [list(row) for row in a.v])


def _kzg_snark_fields(s, arg_fields=_kzg_arg_fields):
    """Every field of a RelaxedR1CSSNARK, its evaluation argument's by
    `arg_fields` (HyperKZG's by default)."""
    return (_polys(s.sc_proof_outer), list(s.claims_outer), s.eval_E,
            _polys(s.sc_proof_inner), s.eval_W, _polys(s.sc_proof_batch),
            list(s.evals_batch), arg_fields(s.eval_arg))


def _ipa_snark_fields(s):
    from tests.test_torch_spartan import snark_fields

    return snark_fields(s)


def _proof_fields(c, arg_fields=_kzg_arg_fields):
    """Every field of a CompressedSNARK, the primary's evaluation argument
    by `arg_fields`."""
    out = {}
    for name in ("r_U_secondary", "r_U_primary", "l_ur_secondary", "l_ur_primary"):
        out[name] = _relaxed(getattr(c, name))
    out["l_u_secondary"] = (c.l_u_secondary.comm_W.to_coordinates(), list(c.l_u_secondary.X))
    for name in ("nifs_Uf_secondary", "nifs_Un_secondary", "nifs_Un_primary"):
        out[name] = getattr(c, name).comm_T.to_coordinates()
    for name in ("ri_secondary", "ri_primary", "wit_blind_r_Wn_primary",
                 "err_blind_r_Wn_primary", "wit_blind_r_Wn_secondary",
                 "err_blind_r_Wn_secondary"):
        out[name] = getattr(c, name)
    out["snark_primary"] = _kzg_snark_fields(c.snark_primary, arg_fields)
    out["snark_secondary"] = _ipa_snark_fields(c.snark_secondary)
    out["zn"] = list(c.zn)
    return out


def test_ivc_with_hyperkzg_compression_matches_reference(kzg_pp, monkeypatch):
    jpp, tpp, _ = kzg_pp
    j, jvk, jzi = _compress(jpp, JRS, JCS, JKZG, cubic(JStep, JNum, JONE, jlc), 23,
                            monkeypatch)
    t, tvk, tzi = _compress(tpp, TRS, TCS, TKZG, cubic(TStep, TNum, TONE, tlc), 23,
                            monkeypatch)
    p = TBN.scalar.p
    z = 2
    for _ in range(STEPS):
        z = (z * z % p * z + z + 5) % p
    assert tzi == jzi == [z]
    assert tvk.pp_digest == jvk.pp_digest
    assert _proof_fields(t) == _proof_fields(j)
    assert t.verify(tvk, STEPS, [2]) == [z]
    t.zn = [(z + 1) % p]
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
    t.zn = [z]
    w = t.snark_primary.eval_arg.w
    w[0] = w[0] + w[1]  # one HyperKZG witness changed
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
