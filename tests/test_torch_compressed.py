"""The port's CompressedSNARK (``nova_tpu_torch.nova.compressed``:
snark/snark with IPA on both curves) against the JAX package on CPU, on
tests/test_torch_ivc.py's cubic circuit with its public parameters carried
across (``interop.public_params``).

Randomness: ``secrets.randbelow`` (the witness blinds, the ZK randomizer
pairs of ``sample_random_instance_witness``) is patched to one seeded
generator, restarted from the same seed for each package; both draw in the
same order. Tolerance: exact (every proof field equal; commitments as
affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.nova.circuit import StepCircuit as JStep
from nova_tpu.nova.compressed import CompressedSNARK as JCS
from nova_tpu.nova.ivc import RecursiveSNARK as JRS
from nova_tpu.frontend.constraint_system import ONE as JONE, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum

from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import StepCircuit as TStep
from nova_tpu_torch.nova.compressed import CompressedSNARK as TCS
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.provider.engines import PallasEngine as TPE

from tests.test_torch_ivc import cubic, cubic_pp  # noqa: F401  (module fixture)
from tests.test_torch_spartan import snark_fields

torch.set_num_threads(1)

STEPS = 2


def _relaxed(U):
    return (U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)


def _compress(pp, RS, CS, circuit, seed, monkeypatch):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    rs = RS.new(pp, circuit, [2])
    for _ in range(STEPS):
        rs.prove_step(pp, circuit)
    pk, vk = CS.setup(pp)
    return CS.prove(pp, pk, rs), vk


def proof_fields(c):
    """Every field of a CompressedSNARK, as plain ints and coordinates."""
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
    out["snark_primary"] = snark_fields(c.snark_primary)
    out["snark_secondary"] = snark_fields(c.snark_secondary)
    out["zn"] = list(c.zn)
    return out


def test_compressed_snark_matches_reference(cubic_pp, monkeypatch):  # noqa: F811
    jpp, tpp = cubic_pp
    j, jvk = _compress(jpp, JRS, JCS, cubic(JStep, JNum, JONE, jlc), 13, monkeypatch)
    t, tvk = _compress(tpp, TRS, TCS, cubic(TStep, TNum, TONE, tlc), 13, monkeypatch)
    assert tvk.pp_digest == jvk.pp_digest
    assert proof_fields(t) == proof_fields(j)
    p = TPE.scalar.p
    z = 2
    for _ in range(STEPS):
        z = (z * z % p * z + z + 5) % p
    assert t.verify(tvk, STEPS, [2]) == j.verify(jvk, STEPS, [2]) == [z]
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [3])
    t.zn = [(z + 1) % p]
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
    t.zn = [z]
    t.snark_primary.eval_W = (t.snark_primary.eval_W + 1) % p
    with pytest.raises(NovaError):
        t.verify(tvk, STEPS, [2])
