"""A CompressedSNARK of the dryrun's trivial circuit proved under a
4-device CPU mesh (``nova_tpu_torch.parallel.use_mesh``) against the JAX
package's unmeshed proof: the same ``proof_to_bytes``, both Spartan outer
sumchecks on the sharded prover (counted), and the proof verifies.

Public parameters come from tests/test_torch_mesh_ivc.py (carried from the
JAX package). Under the mesh every commit of the prover (the folds'
cross-terms, the randomizers' W and E: ~10^4 entries each) goes to
msm_sharded; here a counting stand-in over the host Pippenger answers them,
which keeps the file inside its time: msm_sharded at that size is held
exact in test_torch_mesh_ivc.py.
Randomness: ``secrets.randbelow`` patched to one seeded generator,
restarted for each package. Tolerance: exact (bytes equal)."""

import torch

from nova_tpu import checkpoint as jcheckpoint
from nova_tpu.nova.circuit import TrivialCircuit as JTrivial
from nova_tpu.nova.compressed import CompressedSNARK as JCS

from nova_tpu_torch import checkpoint, parallel
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.nova.circuit import TrivialCircuit as TTrivial
from nova_tpu_torch.nova.compressed import CompressedSNARK as TCS
from nova_tpu_torch.nova.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.ops.fvec import HVec, as_list

from tests.test_torch_mesh_ivc import jax_steps, seeded, trivial_pp  # noqa: F401
from tests.test_torch_parallel_routes import _bases_of

torch.set_num_threads(1)


def test_compressed_snark_under_mesh_matches_reference(trivial_pp, monkeypatch):
    jpp, tpp = trivial_pp
    jrs = jax_steps(jpp, 2, monkeypatch)  # seeds, then two steps
    jpk, _ = JCS.setup(jpp)
    jproof = JCS.prove(jpp, jpk, jrs)

    seeded(monkeypatch)
    circuit = TTrivial()
    rs = TRS.new(tpp, circuit, [0])
    for _ in range(2):
        rs.prove_step(tpp, circuit)
    pk, vk = TCS.setup(tpp)
    sizes, outer = [], []

    def stand_in(s, bases=None, mesh=None, window=None, device_bases=None):
        assert mesh is parallel.current_mesh() is not None
        sizes.append(("T" if isinstance(s, HVec) else "W", len(s)))
        return host_msm(as_list(s), _bases_of(device_bases)[: len(s)])

    real = parallel.prove_cubic_with_three_inputs_sharded
    monkeypatch.setattr(parallel, "msm_sharded", stand_in)
    monkeypatch.setattr(parallel, "prove_cubic_with_three_inputs_sharded",
                        lambda *a: outer.append(len(a[2])) or real(*a))
    with parallel.use_mesh(parallel.make_mesh(4, devices=["cpu"] * 4)):
        proof = TCS.prove(tpp, pk, rs)
    # the secondary's fold, then per curve the randomizer's W and E and the
    # relaxed fold's cross-term (T: the host-native route's HVecs)
    (c1, c2), (v1, v2) = tpp.num_constraints(), tpp.num_variables()
    assert sizes == [("T", c2), ("W", v2), ("W", c2), ("T", c2),
                     ("W", v1), ("W", c1), ("T", c1)]
    assert len(outer) == 2  # the primary's and the secondary's outer sumcheck
    assert checkpoint.proof_to_bytes(proof) == jcheckpoint.proof_to_bytes(jproof)
    assert proof.verify(vk, 2, [0]) == [0]
