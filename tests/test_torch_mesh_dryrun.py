"""The dryrun twin (``nova_tpu_torch.graft_entry.dryrun_multichip``)
on 4- and 8-device CPU meshes: its checks (a)-(c), its RecursiveSNARK under
the mesh and the fold drill, against the JAX package.

The dryrun's PublicParams.setup is swapped for the trivial circuit's
parameters carried from the JAX package (the shapes and keys the setup
would derive). Its MSMs of 2^9 lanes run through msm_sharded with the
native precompute (``test_torch_parallel.native_fixed``); the ~10^4-entry
commits of the trivial circuit's step go to the host Pippenger here
(counted), which keeps the file inside its time: test_torch_mesh_ivc.py
runs its witnesses through msm_sharded. Randomness: ``secrets.randbelow``
patched to one seeded generator; the dryrun draws nothing before its
RecursiveSNARK. Tolerance: exact."""

import pytest
import torch

from nova_tpu_torch import graft_entry
from nova_tpu_torch.nova.ivc import PublicParams as TPP

from tests.test_parallel import _wide_cubic_r1cs
from tests.test_torch_fold import port_shape
from tests.test_torch_mesh_ivc import (  # noqa: F401
    counted_msm,
    ivc_state,
    jax_steps,
    seeded,
    step_commits,
    trivial_pp,
)
from tests.test_torch_parallel import native_precompute  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("D", [4, 8])
def test_dryrun_multichip_on_a_cpu_mesh(D, trivial_pp, monkeypatch, native_precompute):
    jpp, tpp = trivial_pp
    monkeypatch.setattr(TPP, "setup", staticmethod(lambda *a, **k: tpp))
    sizes = counted_msm(monkeypatch, sharded_max=512)
    seeded(monkeypatch)
    out = graft_entry.dryrun_multichip(D, devices=["cpu"] * D)
    assert out["mesh"].size == D and out["pp"] is tpp
    # (a) a direct call, (b) the pair's witness commit (its cross-term has
    # 4 rows), the second step's commits, and the drill's commitment
    n = max(8 * D, 64)
    assert sizes == [("W", n), ("W", n)] + step_commits(tpp) + [("W", n)]
    assert ivc_state(out["rs"]) == ivc_state(jax_steps(jpp, 2, monkeypatch))
    assert out["fold_commit"] is not None


def test_dryrun_shape_is_the_reference_shape():
    from nova_tpu.provider.engines import PallasEngine as JPE

    from nova_tpu_torch.provider.engines import PallasEngine as TPE

    for nv in (64, 96):
        jS = _wide_cubic_r1cs(JPE, num_vars=nv)
        assert port_shape(jS).digest() == graft_entry._wide_cubic_shape(TPE.scalar, nv).digest()
