"""The port's IVC (``nova_tpu_torch.nova.ivc``: the augmented circuits, the
Poseidon RO, the Keccak transcript, RecursiveSNARK new/prove_step/verify)
against the JAX package on CPU.

Public parameters are carried across with ``interop.public_params`` (the
shapes' CSR arrays and the keys' generator rows), so the port derives no
key in pure Python. Randomness: ``secrets.randbelow`` is patched to one
seeded generator, restarted from the same seed for each package, and both
packages draw in the same order. Tolerance: exact (instances, witnesses,
outputs and digests equal; commitments as affine points)."""

import random
import secrets

import pytest
import torch

from nova_tpu.frontend.constraint_system import ONE as JONE, lc as jlc
from nova_tpu.frontend.num import AllocatedNum as JNum
from nova_tpu.nova.circuit import StepCircuit as JStep, TrivialCircuit as JTrivial
from nova_tpu.nova.ivc import PublicParams as JPP, RecursiveSNARK as JRS
from nova_tpu.provider.engines import PallasEngine as JPE, VestaEngine as JVE
from nova_tpu.provider.keccak import Keccak256Transcript as JTranscript
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


@pytest.fixture(scope="module")
def cubic_pp():
    jpp = JPP.setup(JPE, JVE, cubic(JStep, JNum, JONE, jlc))
    return jpp, carried(jpp)


def _matrices(S):
    return (S.num_cons, S.num_vars, S.num_io) + tuple(
        (M.data, M.indices, M.indptr, M.cols) for M in (S.A, S.B, S.C)
    )


def test_augmented_shapes_match_reference():
    """The port's ShapeCS synthesis of both augmented circuits (trivial step
    circuit) gives the JAX package's matrices: 9,818 / 10,349 constraints."""
    jpp = JPP.setup(JPE, JVE, JTrivial())
    shapes = []
    for e_circ, primary, field in ((TVE, True, TPE.scalar), (TPE, False, TVE.scalar)):
        cs = ShapeCS(field)
        NovaAugmentedCircuit(e_circ, primary, None, TTrivial(), TROC(e_circ.base)).synthesize(cs)
        shapes.append(cs.r1cs_shape())
    assert (shapes[0].num_cons, shapes[1].num_cons) == (9818, 10349)
    assert _matrices(shapes[0]) == _matrices(jpp.r1cs_shape_primary)
    assert _matrices(shapes[1]) == _matrices(jpp.r1cs_shape_secondary)
    assert shapes[0].digest() == jpp.r1cs_shape_primary.digest()


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
