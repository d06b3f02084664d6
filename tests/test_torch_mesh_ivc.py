"""A RecursiveSNARK on the trivial step circuit whose folding prove_step
runs under a 4-device CPU mesh (``nova_tpu_torch.parallel.use_mesh``),
against the JAX package's unmeshed RecursiveSNARK: every commit of the step
goes to msm_sharded (counted), and the running instances and witnesses
equal the JAX package's.

Public parameters are carried from the JAX package
(``interop.public_params``), and the window-shifted precompute is the
native one (``test_torch_parallel.native_fixed``). Randomness:
``secrets.randbelow`` is patched to one seeded generator, restarted for
each package. Tolerance: exact (instances, witnesses and outputs equal;
commitments as affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.nova.circuit import TrivialCircuit as JTrivial
from nova_tpu.nova.ivc import RecursiveSNARK as JRS

from nova_tpu_torch import parallel
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.nova.circuit import TrivialCircuit as TTrivial
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.ops.fvec import HVec, as_list

from tests.test_torch_ivc import carried, reference_pp
from tests.test_torch_parallel import native_precompute  # noqa: F401

torch.set_num_threads(1)

SEED = 17


@pytest.fixture(scope="module")
def trivial_pp():
    jpp = reference_pp(JTrivial())
    return jpp, carried(jpp)


def seeded(monkeypatch, seed=SEED):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))


def ivc_state(rs):
    """A RecursiveSNARK's running instances and witnesses, as plain ints."""
    out = {"i": rs.i, "zi": list(rs.zi)}
    for name in ("r_U_primary", "r_U_secondary"):
        U = getattr(rs, name)
        out[name] = (U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)
    for name in ("r_W_primary", "r_W_secondary"):
        W = getattr(rs, name)
        out[name] = (as_list(W.W), as_list(W.E), W.r_W, W.r_E)
    out["l_u_secondary"] = (rs.l_u_secondary.comm_W.to_coordinates(), list(rs.l_u_secondary.X))
    out["l_w_secondary"] = (as_list(rs.l_w_secondary.W), rs.l_w_secondary.r_W)
    return out


def jax_steps(jpp, steps, monkeypatch):
    seeded(monkeypatch)
    circuit = JTrivial()
    rs = JRS.new(jpp, circuit, [0])
    for _ in range(steps):
        rs.prove_step(jpp, circuit)
    return rs


def counted_msm(monkeypatch, sharded_max=None):
    """msm_sharded wrapped to record (kind, length) of each call, kind "T"
    for the cross-terms (HVecs from the host-native route) and "W" for the
    rest. The cross-terms, and every call longer than `sharded_max`, are
    answered by the host Pippenger over the same bases."""
    from tests.test_torch_parallel_routes import _bases_of

    calls = []
    real = parallel.msm_sharded

    def counted(s, bases=None, mesh=None, window=None, device_bases=None):
        calls.append(("T" if isinstance(s, HVec) else "W", len(s)))
        if isinstance(s, HVec) or (sharded_max is not None and len(s) > sharded_max):
            return host_msm(as_list(s), _bases_of(device_bases)[: len(s)])
        return real(s, bases, mesh=mesh, window=window, device_bases=device_bases)

    monkeypatch.setattr(parallel, "msm_sharded", counted)
    return calls


def step_commits(tpp):
    """The commits of a folding prove_step, in order: the secondary's
    cross-term, the primary's witness, the primary's cross-term, the
    secondary's witness."""
    (c1, c2), (v1, v2) = tpp.num_constraints(), tpp.num_variables()
    return [("T", c2), ("W", v1), ("T", c1), ("W", v2)]


def test_prove_step_under_mesh_matches_reference(trivial_pp, monkeypatch, native_precompute):
    """The witness commits run through msm_sharded; the cross-terms (the
    host-native route's HVecs, as long) through the host Pippenger, to keep
    the file inside its time (an HVec's sharded MSM is held in
    test_torch_parallel_msm.py)."""
    jpp, tpp = trivial_pp
    sizes = counted_msm(monkeypatch)
    seeded(monkeypatch)
    circuit = TTrivial()
    rs = TRS.new(tpp, circuit, [0])
    rs.prove_step(tpp, circuit)  # the first step only bumps the counter
    with parallel.use_mesh(parallel.make_mesh(4, devices=["cpu"] * 4)):
        rs.prove_step(tpp, circuit)
    assert sizes == step_commits(tpp)
    assert ivc_state(rs) == ivc_state(jax_steps(jpp, 2, monkeypatch))
    assert rs.verify(tpp, 2, [0]) == [0]
