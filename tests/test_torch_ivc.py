"""The port's IVC (``nova_tpu_torch.nova.ivc``: the augmented circuits, the
Poseidon RO, the Keccak transcript, RecursiveSNARK new/prove_step/verify)
against the JAX package on CPU.

Public parameters are carried across with ``interop.public_params`` (the
shapes' CSR arrays and the keys' generator rows); the JAX package's own
PublicParams are built from its ShapeCS shapes and keys the port derives
in a process pool (``reference_pp``). Randomness: ``secrets.randbelow`` is patched to one
seeded generator, restarted from the same seed for each package, and both
packages draw in the same order. Tolerance: exact (instances, witnesses,
outputs and digests equal; commitments as affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.frontend.constraint_system import ONE as JONE, ShapeCS as JShapeCS, lc as jlc
from nova_tpu.curves.spec import AffinePoint as JAffine
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import NovaAugmentedCircuit as JAug
from nova_tpu.nova.circuit import StepCircuit as JStep, TrivialCircuit as JTrivial
from nova_tpu.nova.ivc import PublicParams as JPP, RecursiveSNARK as JRS
from nova_tpu.provider.engines import PallasEngine as JPE, VestaEngine as JVE
from nova_tpu.provider.keccak import Keccak256Transcript as JTranscript
from nova_tpu.provider.pedersen import CommitmentKey as JCommitmentKey
from nova_tpu.provider.poseidon import PoseidonRO as JRO, PoseidonROConstants as JROC

from nova_tpu_torch import interop
from nova_tpu_torch.errors import NovaError
from nova_tpu_torch.frontend.constraint_system import ONE as TONE, ShapeCS, lc as tlc
from nova_tpu_torch.frontend.num import AllocatedNum as TNum
from nova_tpu_torch.nova.circuit import (
    NovaAugmentedCircuit,
    StepCircuit as TStep,
    TrivialCircuit as TTrivial,
)
from nova_tpu_torch.nova.ivc import PublicParams as TPP, RecursiveSNARK as TRS
from nova_tpu_torch.ops.fvec import as_list
from nova_tpu_torch.provider.engines import PallasEngine as TPE, VestaEngine as TVE
from nova_tpu_torch.provider.keccak import Keccak256Transcript as TTranscript
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE
from nova_tpu_torch.provider.poseidon import PoseidonRO as TRO, PoseidonROConstants as TROC

from tests.test_torch_fold import key_rows, shape_arrays

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)


def cubic(Step, Num, ONE, lc):
    """tests/test_ivc.py's CubicCircuit (y = x^3 + x + 5) on one package's
    frontend."""

    class Cubic(Step):
        def arity(self):
            return 1

        def synthesize(self, cs, z):
            x = z[0]
            x_cu = x.square(cs).mul(cs, x)
            p = cs.field.p

            def val():
                if x_cu.get_value() is None:
                    return None
                return (x_cu.get_value() + x.get_value() + 5) % p

            y = Num.alloc(cs, val)
            cs.enforce(
                lc((1, x_cu.get_variable()), (1, x.get_variable()), (5, ONE)),
                lc((1, ONE)),
                lc((1, y.get_variable())),
            )
            return [y]

    return Cubic()


def carried(jpp, device="cpu"):
    """The port's PublicParams built from the JAX package's."""
    return interop.public_params(
        TPE, TVE, jpp.F_arity,
        shape_arrays(jpp.r1cs_shape_primary), key_rows(jpp.ck_primary),
        shape_arrays(jpp.r1cs_shape_secondary), key_rows(jpp.ck_secondary),
        device=device,
    )


def augmented_shapes(pkg, step):
    """Both augmented circuits' shapes (the step circuit on the primary, the
    trivial one on the secondary), synthesized by one package's ShapeCS the
    way its PublicParams.setup does."""
    CS, Aug, Trivial, ROC, (e1, e2) = pkg
    shapes = []
    for e_circ, primary, field, c in ((e2, True, e1.scalar, step),
                                      (e1, False, e2.scalar, Trivial())):
        cs = CS(field)
        Aug(e_circ, primary, None, c, ROC(e_circ.base)).synthesize(cs)
        shapes.append(cs.r1cs_shape())
    return shapes


JAX = (JShapeCS, JAug, JTrivial, JROC, (JPE, JVE))
PORT = (ShapeCS, NovaAugmentedCircuit, TTrivial, TROC, (TPE, TVE))


def reference_pp(step):
    """The JAX package's PublicParams for `step`, built through its own
    constructor from its own shapes, with keys whose generators the port
    derives in a process pool and caches (the JAX package derives them
    serially; tests/test_torch_pedersen.py holds the two derivations
    equal)."""
    shapes = augmented_shapes(JAX, step)
    keys = []
    for S, je, te in zip(shapes, (JPE, JVE), (TPE, TVE)):
        tck = TCE.setup(te.curve, b"ck", max(S.num_cons, S.num_vars), device="cpu")
        gens = [JAffine(je.curve, g.x, g.y, g.infinity) for g in [tck.h] + tck.ck]
        keys.append(JCommitmentKey(je.curve, gens[1:], gens[0]))
    pp = JPP(JPE, JVE, step.arity(), shapes[0], keys[0], shapes[1], keys[1])
    pp.digest()
    return pp


@pytest.fixture(scope="module")
def cubic_pp():
    jpp = reference_pp(cubic(JStep, JNum, JONE, jlc))
    return jpp, carried(jpp)


def _matrices(S):
    return (S.num_cons, S.num_vars, S.num_io) + tuple(
        (M.data, M.indices, M.indptr, M.cols) for M in (S.A, S.B, S.C)
    )


def test_augmented_shapes_match_reference():
    """The port's ShapeCS synthesis of both augmented circuits (trivial step
    circuit) gives the JAX package's matrices and digest: 9,818 / 10,349
    constraints."""
    j1, j2 = augmented_shapes(JAX, JTrivial())
    t1, t2 = augmented_shapes(PORT, TTrivial())
    assert (t1.num_cons, t2.num_cons) == (9818, 10349)
    assert _matrices(t1) == _matrices(j1)
    assert _matrices(t2) == _matrices(j2)
    assert t1.digest() == j1.digest()


@pytest.mark.parametrize("engines", [(JPE, TPE), (JVE, TVE)], ids=["pallas", "vesta"])
def test_poseidon_ro_matches_reference(engines):
    je, te = engines
    rng = random.Random(3)
    vals = [rng.randrange(je.base.p) for _ in range(30)]
    outs = []
    for RO, ROC in ((JRO, JROC), (TRO, TROC)):
        ro = RO(ROC(je.base))
        for v in vals:
            ro.absorb(v)
        a = ro.squeeze(250)
        ro.absorb(7)
        outs.append((a, ro.squeeze(128, True), RO(ROC(je.base), "narrow").squeeze_scalar()))
    assert outs[0] == outs[1]
    assert te.new_ro().constants.wide.width == je.new_ro().constants.wide.width


def test_keccak_transcript_matches_reference():
    outs = []
    for T, field in ((JTranscript, JPE.scalar), (TTranscript, TPE.scalar)):
        t = T(b"port-test", field)
        t.absorb(b"a", b"\x01\x02\x03")
        t.dom_sep(b"sep")
        s1 = t.squeeze(b"c1")
        t.absorb(b"b", bytes(range(100)))
        outs.append((s1, t.squeeze_bits(b"c2", 128, True)))
    assert outs[0] == outs[1]


def test_pp_digest_matches_reference(cubic_pp):
    jpp, tpp = cubic_pp
    assert tpp.digest() == jpp.digest()
    assert tpp.num_constraints() == jpp.num_constraints()
    assert tpp.num_variables() == jpp.num_variables()
    assert tpp.ck_primary.device.type == "cpu"


def _run(RS, pp, circuit, z0, steps, seed, monkeypatch):
    rnd = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
    rs = RS.new(pp, circuit, z0)
    for _ in range(steps):
        rs.prove_step(pp, circuit)
    return rs


def _relaxed(U):
    return (U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)


def test_recursive_snark_matches_reference(cubic_pp, monkeypatch):
    jpp, tpp = cubic_pp
    steps = 3
    j = _run(JRS, jpp, cubic(JStep, JNum, JONE, jlc), [2], steps, 11, monkeypatch)
    t = _run(TRS, tpp, cubic(TStep, TNum, TONE, tlc), [2], steps, 11, monkeypatch)
    assert t.i == j.i == steps and t.zi == j.zi
    for name in ("r_U_primary", "r_U_secondary"):
        assert _relaxed(getattr(t, name)) == _relaxed(getattr(j, name)), name
    assert t.l_u_secondary.comm_W.to_coordinates() == j.l_u_secondary.comm_W.to_coordinates()
    assert t.l_u_secondary.X == j.l_u_secondary.X
    for name in ("r_W_primary", "r_W_secondary"):
        tw, jw = getattr(t, name), getattr(j, name)
        assert as_list(tw.W) == list(jw.W) and as_list(tw.E) == list(jw.E), name
        assert (tw.r_W, tw.r_E) == (jw.r_W, jw.r_E), name
    p = TPE.scalar.p
    z = 2
    for _ in range(steps):
        z = (z * z % p * z + z + 5) % p
    assert t.verify(tpp, steps, [2]) == j.verify(jpp, steps, [2]) == [z]
    with pytest.raises(NovaError):
        t.verify(tpp, steps + 1, [2])
    with pytest.raises(NovaError):
        t.verify(tpp, steps, [3])


def test_setup_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPP.setup(TPE, TVE, TTrivial())
