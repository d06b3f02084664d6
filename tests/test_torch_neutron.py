"""The port's NeutronNova (``nova_tpu_torch.neutron``: the zero-fold NIFS,
the augmented circuit, the IVC) against the JAX package on CPU.

Shapes and keys are carried across with ``nova_tpu_torch.interop``; the
IVC's public parameters with ``interop.neutron_public_params``, from JAX
parameters built through their own constructor with keys the port derives
(tests/test_torch_ivc.py's pattern). Randomness: ``secrets.randbelow`` is
patched to one seeded generator, restarted from the same seed for each
package. Tolerance: exact (field values, polynomial coefficients,
commitments as affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.curves.spec import AffinePoint as JAffine
from nova_tpu.frontend.constraint_system import ShapeCS as JShapeCS
from nova_tpu.neutron import (
    FoldedInstance as JFoldedInstance,
    FoldedWitness as JFoldedWitness,
    NIFS as JNIFS,
    Structure as JStructure,
)
from nova_tpu.neutron.circuit import NeutronAugmentedCircuit as JAug
from nova_tpu.neutron.ivc import PublicParams as JPP, RecursiveSNARK as JRS
from nova_tpu.nova.circuit import TrivialCircuit as JTrivial
from nova_tpu.provider.engines import PallasEngine as JPE, VestaEngine as JVE
from nova_tpu.provider.pedersen import CommitmentKey as JCommitmentKey
from nova_tpu.provider.poseidon import PoseidonROConstants as JROC

from nova_tpu_torch import constants, interop, native
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ShapeCS
from nova_tpu_torch.neutron import FoldedInstance, FoldedWitness, NIFS, Structure
from nova_tpu_torch.neutron.circuit import NeutronAugmentedCircuit
from nova_tpu_torch.neutron.ivc import RecursiveSNARK as TRS
from nova_tpu_torch.nova.circuit import TrivialCircuit
from nova_tpu_torch.provider.engines import (
    Bn256EngineKZG,
    PallasEngine as TPE,
    Secp256k1Engine,
    VestaEngine as TVE,
)
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE
from nova_tpu_torch.provider.poseidon import PoseidonROConstants
from nova_tpu_torch.r1cs import R1CSInstance, R1CSWitness

from tests.test_nifs import satisfying_pair, tiny_r1cs
from tests.test_torch_fold import key_rows, port_key, port_shape, shape_arrays
from tests.test_torch_ivc import _matrices

torch.set_num_threads(1)

P = TPE.scalar.p


@pytest.mark.parametrize("engine,want", [(TPE, 7047), (Bn256EngineKZG, 7327),
                                         (Secp256k1Engine, 7792)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_neutron_circuit_constraint_goldens(engine, want):
    """src/neutron/circuit/mod.rs:436-440, and the JAX package's matrices
    on Pallas."""
    cs = ShapeCS(engine.scalar)
    NeutronAugmentedCircuit(None, TrivialCircuit(), PoseidonROConstants(engine.scalar)
                            ).synthesize(cs)
    assert cs.num_constraints() == want
    if engine is TPE:
        jcs = JShapeCS(JPE.scalar)
        JAug(None, JTrivial(), JROC(JPE.scalar)).synthesize(jcs)
        assert _matrices(cs.r1cs_shape()) == _matrices(jcs.r1cs_shape())


def _port_pair(S, ck, x):
    """tests/test_nifs.py's satisfying_pair with the port's classes."""
    f = TPE.scalar
    z0 = f.mul(x, x)
    z1 = f.mul(z0, x)
    z2 = f.add(z1, x)
    W = R1CSWitness.new(S, [z0, z1, z2, 0])
    return R1CSInstance.new(S, W.commit(ck), [x, f.add(z2, 5)]), W


def _folded(U):
    return (U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), U.T, U.u, list(U.X))


@pytest.mark.parametrize("route", ["host", "device"])
def test_nifs_matches_reference(route, monkeypatch):
    """NIFS.prove / verify over tests/test_nifs.py's tiny R1CS with a fixed
    r_E for each fold: comm_E, the round polynomial, T, u, X and comm_W
    equal the JAX package's; the folded pair satisfies the structure; a
    changed T fails. The device route lowers DEVICE_THRESHOLD to 1, so the
    SpMV and the commits take the device SpMV and msm_device2 (plain
    versions on these CPU tensors, ~1 s a commit: one fold there)."""
    xs = (3, 5, 7)
    if route == "device":
        monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)
        xs = (3,)
    jS = tiny_r1cs(JPE)
    jst = JStructure(jS)
    jck = jst.S.commitment_key(b"ck", 0)
    st = Structure(port_shape(jst.S))
    ck = port_key(jck)
    assert (st.ell, st.left, st.right) == (jst.ell, jst.left, jst.right)
    jU, jW = JFoldedInstance.default(JPE.curve, jst), JFoldedWitness.default(jst)
    U, W = FoldedInstance.default(TPE.curve, st), FoldedWitness.default(st)
    digest = 0xD16E57
    rng = random.Random(5)
    for x in xs:
        r_W, r_E = rng.randrange(P), rng.randrange(P)
        monkeypatch.setattr(secrets, "randbelow", lambda n: r_W)
        ju2, jw2 = satisfying_pair(JPE, jst.S, jck, x)
        u2, w2 = _port_pair(st.S, ck, x)
        assert u2.comm_W.to_coordinates() == ju2.comm_W.to_coordinates()
        jn, (jU, jW) = JNIFS.prove(jck, JPE, digest, jst, jU, jW, ju2, jw2, r_E=r_E)
        n, (U_p, W_p) = NIFS.prove(ck, TPE, digest, st, U, W, u2, w2, r_E=r_E)
        assert n.comm_E.to_coordinates() == jn.comm_E.to_coordinates()
        assert list(n.poly.coeffs) == list(jn.poly.coeffs)
        assert _folded(U_p) == _folded(jU)
        assert (W_p.W, W_p.r_W, W_p.E, W_p.r_E) == (jW.W, jW.r_W, jW.E, jW.r_E)
        U_v = n.verify(TPE, digest, U, u2)
        assert _folded(U_v) == _folded(U_p)
        U, W = U_p, W_p
        st.is_sat(ck, U, W)
    bad = FoldedInstance(U.comm_W, U.comm_E, (U.T + 1) % P, U.u, U.X)
    with pytest.raises(NovaError):
        st.is_sat(ck, bad, W)


def test_round_helper_native_python_and_reference(monkeypatch):
    """The port's 5-point round polynomial, native and in Python, equals the
    JAX package's."""
    rng = random.Random(7)
    left, right = 16, 8
    n = left * right

    def mk(m):
        return [rng.randrange(P) for _ in range(m)]

    args = (left, right, mk(left + right), mk(n), mk(n), mk(n), mk(left + right),
            mk(n), mk(n), mk(n))
    rho = rng.randrange(P)
    assert native.available()
    got = NIFS._prove_helper(TPE.scalar, rho, *args)
    want = JNIFS._prove_helper(JPE.scalar, rho, *args)
    monkeypatch.setattr(native, "available", lambda: False)
    assert NIFS._prove_helper(TPE.scalar, rho, *args) == got == want


def reference_neutron_pp(step):
    """The JAX package's Neutron PublicParams for `step`, built through its
    own constructor from its ShapeCS shape, with a key the port derives."""
    cs = JShapeCS(JPE.scalar)
    JAug(None, step, JROC(JPE.scalar)).synthesize(cs)
    shape = cs.r1cs_shape()
    tck = TCE.setup(TPE.curve, b"ck", max(shape.num_cons, shape.num_vars), device="cpu")
    gens = [JAffine(JPE.curve, g.x, g.y, g.infinity) for g in [tck.h] + tck.ck]
    ck = JCommitmentKey(JPE.curve, gens[1:], gens[0])
    pp = JPP(JPE, JVE, step.arity(), ck, JStructure(shape))
    pp.digest()
    return pp


def _run(RS, pp, circuit, steps, monkeypatch):
    rnd = random.Random(31)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    rs = RS.new(pp, circuit, [1])
    for _ in range(steps):
        rs.prove_step(pp, circuit)
    return rs


def test_neutron_ivc_matches_reference(monkeypatch):
    steps = 3
    jpp = reference_neutron_pp(JTrivial())
    tpp = interop.neutron_public_params(TPE, TVE, 1, shape_arrays(jpp.structure.S),
                                        key_rows(jpp.ck), device="cpu")
    assert tpp.digest() == jpp.digest()
    assert tpp.ck.device.type == "cpu"
    j = _run(JRS, jpp, JTrivial(), steps, monkeypatch)
    t = _run(TRS, tpp, TrivialCircuit(), steps, monkeypatch)
    assert t.i == j.i == steps and t.zi == j.zi == [1] and t.ri == j.ri
    assert _folded(t.r_U) == _folded(j.r_U)
    assert (t.r_W.W, t.r_W.r_W, t.r_W.E, t.r_W.r_E) == (j.r_W.W, j.r_W.r_W, j.r_W.E, j.r_W.r_E)
    assert t.l_u.comm_W.to_coordinates() == j.l_u.comm_W.to_coordinates()
    assert t.l_u.X == j.l_u.X and t.l_w.W == j.l_w.W and t.l_w.r_W == j.l_w.r_W
    assert t.verify(tpp, steps, [1]) == j.verify(jpp, steps, [1]) == [1]
    with pytest.raises(NovaError):
        t.verify(tpp, steps + 1, [1])
    T = t.r_U.T
    t.r_U.T = (T + 1) % P
    with pytest.raises(NovaError):
        t.verify(tpp, steps, [1])
    t.r_U.T = T
