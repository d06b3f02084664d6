"""The mesh's sumcheck, fold drill and routes (``nova_tpu_torch.parallel``
and the mesh branches of the Pedersen engine and Spartan) on CPU meshes,
against the JAX package:

- prove_cubic_with_three_inputs_sharded at 2^6 and 2^8 on 4 and 8 devices
  against the JAX host prover under NOVA_NO_GRUEN=1, and the port's
  NOVA_NO_GRUEN switch (both host routes give the JAX proof);
- run_sharded_fold_step's commitment against the JAX version's (its fold
  kernel and MSM swapped for stand-ins that draw nothing, so its own draw
  order decides the scalars), and the elementwise fold against host ints;
- a NIFS fold under use_mesh against the JAX fold and the unmeshed one;
- which route each call takes under a mesh (counted): commits of 8 or
  more entries (int list, HVec, FVec) to msm_sharded, shorter ones not;
  batch_commit and commit_small skip their batched and device routes;
  Spartan and ppsnark prove their outer sumcheck sharded (proofs equal to
  the JAX package's). In those routing tests msm_sharded is a counting
  stand-in over the host Pippenger (it is held exact in
  test_torch_parallel.py).

Tolerance: exact (field values, proofs, points in affine form)."""

import random

import pytest
import torch

import nova_tpu.parallel as jparallel
import nova_tpu.r1cs as jr1cs
from nova_tpu.curves.msm_host import msm as jhost_msm
from nova_tpu.curves.spec import AffinePoint as JAffine, pallas as JPALLAS
from nova_tpu.nova.nifs import NIFS as JNIFS
from nova_tpu.provider.engines import PallasEngine as JPE
from nova_tpu.provider.keccak import Keccak256Transcript as JTranscript
from nova_tpu.provider.pedersen import CommitmentKey as JCommitmentKey
from nova_tpu.spartan.polys import MultilinearPolynomial as JML
from nova_tpu.spartan.ppsnark import RelaxedR1CSSNARK as JPP
from nova_tpu.spartan.snark import RelaxedR1CSSNARK as JSNARK
from nova_tpu.spartan.sumcheck import SumcheckProof as JSC

from nova_tpu_torch import constants, graft_entry, native, parallel
from nova_tpu_torch import r1cs as tr1cs
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.curves.spec import pallas
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.nova.nifs import NIFS
from nova_tpu_torch.ops import msm3
from nova_tpu_torch.ops.fvec import FVec, HVec, as_list
from nova_tpu_torch.provider.engines import PallasEngine as TPE
from nova_tpu_torch.provider.keccak import Keccak256Transcript as TTranscript
from nova_tpu_torch.provider.pedersen import CommitmentEngine as TCE
from nova_tpu_torch.spartan import ppsnark, snark
from nova_tpu_torch.spartan.polys import MultilinearPolynomial as TML
from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as TPP
from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK as TSNARK
from nova_tpu_torch.spartan.sumcheck import SumcheckProof as TSC

from tests.test_parallel import _wide_cubic_r1cs
from tests.test_torch_fold import port_key, port_shape
from tests.test_torch_parallel import native_precompute, xy  # noqa: F401
from tests.test_torch_ppsnark import _keys, _shapes, pp_fields
from tests.test_torch_spartan import _derandomized_pair, snark_fields

torch.set_num_threads(1)

F = JPE.scalar
P = F.p


def cpu_mesh(D):
    return parallel.make_mesh(D, devices=["cpu"] * D)


def _polys(proof):
    return [cp.coeffs_except_linear_term for cp in proof.compressed_polys]


def _tables(k, seed):
    rng = random.Random(seed)
    taus = [rng.randrange(P) for _ in range(k)]
    A = [rng.randrange(P) for _ in range(1 << k)]
    B = [rng.randrange(P) for _ in range(1 << k)]
    return taus, A, B, [a * b % P for a, b in zip(A, B)]


def _jax_host(taus, A, B, C, monkeypatch):
    monkeypatch.setenv("NOVA_NO_GRUEN", "1")
    out = JSC.prove_cubic_with_three_inputs(
        F, 0, taus, JML(F, list(A)), JML(F, list(B)), JML(F, list(C)), JTranscript(b"t", F))
    monkeypatch.delenv("NOVA_NO_GRUEN")
    return _polys(out[0]), out[1], out[2]


@pytest.mark.parametrize("k,D", [(6, 4), (6, 8), (8, 4), (8, 8)])
def test_sharded_outer_sumcheck_matches_reference(k, D, monkeypatch):
    taus, A, B, C = _tables(k, 0x5C + k)
    want = _jax_host(taus, A, B, C, monkeypatch)
    hv = HVec(P, ints=C)  # the tables come as int lists or HVecs
    proof, r, claims = parallel.prove_cubic_with_three_inputs_sharded(
        F, 0, taus, A, B, hv, TTranscript(b"t", F), cpu_mesh(D))
    assert (_polys(proof), r, claims) == want
    assert claims == [TML(F, t).evaluate(r) for t in (A, B, C)]


def test_sharded_sumcheck_refuses_a_short_split():
    taus, A, B, C = _tables(2, 1)
    with pytest.raises(ValueError):
        parallel.prove_cubic_with_three_inputs_sharded(
            F, 0, taus, A, B, C, TTranscript(b"t", F), cpu_mesh(4))


def test_no_gruen_switch_gives_the_reference_proof(monkeypatch):
    """The port's native host prover with the Gruen rounds and, under
    NOVA_NO_GRUEN=1, with the eq table bound: the JAX package's proof both
    ways, each route taken (counted)."""
    taus, A, B, C = _tables(7, 3)
    want = _jax_host(taus, A, B, C, monkeypatch)
    seen = []
    for name in ("sumcheck_cubic_gruen_round_l", "sumcheck_cubic_round_l"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _n=name, _r=real: seen.append(_n) or _r(*a))
    for env in (None, "1"):
        if env:
            monkeypatch.setenv("NOVA_NO_GRUEN", env)
        seen.clear()
        out = TSC.prove_cubic_with_three_inputs(
            F, 0, taus, TML(F, list(A)), TML(F, list(B)), TML(F, list(C)),
            TTranscript(b"t", F))
        assert (_polys(out[0]), out[1], out[2]) == want
        assert set(seen) == {"sumcheck_cubic_round_l" if env else "sumcheck_cubic_gruen_round_l"}


def test_fold_drill_commitment_matches_reference(monkeypatch, native_precompute):
    def no_fold(field_p, mesh, az, bz, cz, e, w1, w2, u, r):
        return az, w1, e, az[0], az[0]

    def host(scalars, bases, mesh=None):
        return jhost_msm(list(scalars), bases)

    monkeypatch.setattr(jparallel, "_fold_elementwise_kernel", no_fold)
    monkeypatch.setattr(jparallel, "msm_sharded", host)
    want = jparallel.run_sharded_fold_step(jparallel.make_mesh(4), JPALLAS.base, 64)
    got = parallel.run_sharded_fold_step(cpu_mesh(4), pallas.base, 64)
    assert xy(got) == (want.x, want.y, want.infinity)


def test_fold_elementwise_matches_host_ints():
    rng = random.Random(5)
    tf = TField(pallas.base)
    p = pallas.base.p
    n, D = 32, 4
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(6)]
    u, r = rng.randrange(p), rng.randrange(p)
    mont = [tf.to_mont(torch.from_numpy(tf.pack(v))) for v in vals]
    T, Wn, En, s0, sinf = parallel.fold_elementwise_sharded(cpu_mesh(D), tf, *mont, u, r)
    az, bz, cz, e, w1, w2 = vals
    t = [(a * b - u * c - x) % p for a, b, c, x in zip(az, bz, cz, e)]

    def ints(blocks):
        return tf.unpack(tf.from_mont(torch.cat(blocks)))

    assert ints(T) == t
    assert ints(Wn) == [(a + r * b) % p for a, b in zip(w1, w2)]
    assert ints(En) == [(x + r * y) % p for x, y in zip(e, t)]
    m = n // D
    lo = [v for d in range(D) for v in t[d * m : d * m + m // 2]]
    hi = [v for d in range(D) for v in t[d * m + m // 2 : (d + 1) * m]]
    assert tf.unpack(tf.from_mont(s0[None]))[0] == sum(x * x for x in lo) % p
    assert tf.unpack(tf.from_mont(sinf[None]))[0] == sum((h - x) ** 2 for h, x in zip(hi, lo)) % p


def _wide_pair(r1cs, S, ck, x, num_vars):
    f = F
    z0 = f.mul(x, x)
    z1 = f.mul(z0, x)
    z2 = f.add(z1, x)
    W = r1cs.R1CSWitness.new(S, [z0, z1, z2] + [0] * (num_vars - 3), r_W=7)
    return r1cs.R1CSInstance.new(S, W.commit(ck), [x, f.add(z2, 5)]), W


def test_nifs_fold_under_mesh_matches_reference(native_precompute):
    """The dryrun's widened cubic R1CS (the JAX tests' shape) folded under a
    4-device mesh: every W commit sharded, the same folded pair as the JAX
    package's fold and the port's unmeshed fold, and satisfied."""
    jS = _wide_cubic_r1cs(JPE)
    tS = graft_entry._wide_cubic_shape(TPE.scalar, 64)
    assert port_shape(jS).digest() == tS.digest()
    tck = tS.commitment_key(device="cpu")
    gens = [JAffine(JPALLAS, g.x, g.y, g.infinity) for g in [tck.h] + tck.ck]
    jck = JCommitmentKey(JPALLAS, gens[1:], gens[0])
    jU2, jW2 = _wide_pair(jr1cs, jS, jck, 9, 64)
    _, (jU, jW) = JNIFS.prove(jck, JPE, 0x1234, jS, jr1cs.RelaxedR1CSInstance.default(
        JPALLAS, jS), jr1cs.RelaxedR1CSWitness.default(jS), jU2, jW2, r_T=11)
    outs = []
    for mesh in (cpu_mesh(4), None):
        r_U = tr1cs.RelaxedR1CSInstance.default(pallas, tS)
        r_W = tr1cs.RelaxedR1CSWitness.default(tS)
        with parallel.use_mesh(mesh):
            U2, W2 = _wide_pair(tr1cs, tS, tck, 9, 64)
            _, (U, W) = NIFS.prove(tck, TPE, 0x1234, tS, r_U, r_W, U2, W2, r_T=11)
        outs.append((U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), U.u, list(U.X),
                     as_list(W.W), as_list(W.E), W.r_W, W.r_E))
    tS.is_sat_relaxed(tck, U, W)
    want = (jU.comm_W.to_coordinates(), jU.comm_E.to_coordinates(), jU.u, list(jU.X),
            list(jW.W), list(jW.E), jW.r_W, jW.r_E)
    assert outs[0] == outs[1] == want


def _bases_of(db):
    """The affine points a DeviceBases2 holds."""
    from nova_tpu_torch.curves.spec import AffinePoint

    tf = db.tf
    xs, ys = tf.unpack(tf.from_mont(db.x)), tf.unpack(tf.from_mont(db.y))
    return [AffinePoint.identity(db.curve) if inf else AffinePoint(db.curve, x, y)
            for x, y, inf in zip(xs, ys, db.inf.tolist())]


@pytest.fixture
def counted_shard(monkeypatch):
    """msm_sharded replaced by a stand-in that records each call's length
    and returns the host Pippenger over the same bases."""
    calls = []

    def stand_in(scalars, bases=None, mesh=None, window=None, device_bases=None):
        assert mesh is parallel.current_mesh() is not None
        calls.append(len(scalars))
        pts = bases if bases is not None else _bases_of(device_bases)
        return _port_point(jhost_msm(as_list(scalars), [
            JAffine(JPALLAS, b.x, b.y, b.infinity) for b in pts[: len(scalars)]]))

    monkeypatch.setattr(parallel, "msm_sharded", stand_in)
    return calls


def _port_point(jp):
    from nova_tpu_torch.curves.spec import AffinePoint

    return AffinePoint(pallas, jp.x, jp.y, jp.infinity)


def _key(n=64, label=b"port-mesh-routes"):
    return TCE.setup(pallas, label, n, device="cpu", workers=1)


def test_commit_routes_under_mesh(counted_shard, monkeypatch):
    ck = _key()
    rng = random.Random(11)
    vals = [rng.randrange(pallas.scalar.p) for _ in range(20)]
    small = [x % 1000 for x in vals]
    want = [TCE.commit(ck, v, 5).point for v in (vals, vals[:7])]
    want_small = host_msm(small, ck.ck[:20])
    assert counted_shard == []
    for name in ("msm_device3_mont", "msm_device3_mont_batch", "msm_device3"):
        monkeypatch.setattr(msm3, name, lambda *a, **k: pytest.fail("device route taken"))
    monkeypatch.setattr(native, "msm_cached",
                        lambda *a, **k: pytest.fail("native host MSM taken"))
    with parallel.use_mesh(cpu_mesh(4)):
        got = [TCE.commit(ck, v, 5).point for v in (
            vals, HVec(pallas.scalar.p, ints=vals),
            FVec.from_ints(pallas.scalar, vals, device="cpu"))]
        assert counted_shard == [20, 20, 20]
        assert got == [want[0]] * 3
        short = TCE.commit(ck, vals[:7], 5).point  # under 8 entries: host MSM
        assert counted_shard == [20] * 3 and short == want[1]
        batch = TCE.batch_commit(ck, [FVec.from_ints(pallas.scalar, v, device="cpu")
                                      for v in (vals, vals[:12])], [5, 0])
        assert counted_shard == [20] * 4 + [12]
        assert batch[0].point == want[0]
        monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)
        assert TCE.commit_small(ck, small, 0).point == want_small
        assert counted_shard[-1] == 20 and len(counted_shard) == 6


def test_prove_outer_route_order(monkeypatch):
    """The outer sumcheck's ladder: the sharded prover when the mesh has
    more than one device and 2 or more evaluations a device, before the
    device route; snark and ppsnark share it."""
    assert ppsnark._prove_outer is snark._prove_outer
    seen = []
    real = parallel.prove_cubic_with_three_inputs_sharded
    monkeypatch.setattr(parallel, "prove_cubic_with_three_inputs_sharded",
                        lambda *a: seen.append(a[-1].size) or real(*a))
    monkeypatch.setattr(constants, "DEVICE_THRESHOLD", 1)  # device route otherwise

    class Shape:
        num_cons = 8

    taus, A, B, C = _tables(3, 7)
    want = _jax_host(taus, A, B, C, monkeypatch)
    for D, sharded in ((4, True), (8, False), (1, False)):
        seen.clear()
        with parallel.use_mesh(cpu_mesh(D)):
            out = snark._prove_outer(F, Shape, taus, A, B, C, TTranscript(b"t", F), "cpu")
        assert (_polys(out[0]), out[1], out[2]) == want
        assert seen == ([D] if sharded else [])


def test_snark_under_mesh_matches_reference(monkeypatch):
    """RelaxedR1CSSNARK on the tiny cubic R1CS (4 constraints, 64
    variables) under a 2-device mesh: its outer sumcheck sharded (once),
    every proof field equal to the JAX package's, and the proof verifies."""
    from tests.test_nifs import tiny_r1cs

    jS = tiny_r1cs(JPE, num_vars=64)
    jck = jS.commitment_key(b"ck", 0)
    tS, tck = port_shape(jS), port_key(jck)
    jU, jW = _derandomized_pair(jr1cs, jS, jck, 3, 1001)
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 3, 1001)
    jpk, _ = JSNARK.setup(JPE, jck, jS)
    tpk, tvk = TSNARK.setup(TPE, tck, tS)
    jproof = JSNARK.prove(JPE, jck, jpk, jS, jU, jW)
    seen = []
    real = parallel.prove_cubic_with_three_inputs_sharded
    monkeypatch.setattr(parallel, "prove_cubic_with_three_inputs_sharded",
                        lambda *a: seen.append(1) or real(*a))
    with parallel.use_mesh(cpu_mesh(2)):
        tproof = TSNARK.prove(TPE, tck, tpk, tS, tU, tW)
    assert seen == [1]
    assert snark_fields(tproof) == snark_fields(jproof)
    tproof.verify(tvk, tU)


def test_ppsnark_under_mesh_matches_reference(counted_shard, monkeypatch):
    """ppsnark (Pallas, IPA) on the cubic R1CS padded to 32 variables under
    a 2-device mesh: the outer sumcheck sharded, its commits routed to
    msm_sharded, and every proof field equal to the JAX package's."""
    jS, tS = _shapes(JPE, TPE, 32)
    jck, tck = _keys("pallas-ipa", jS)
    jU, jW = _derandomized_pair(jr1cs, jS, jck, 3, 1001)
    tU, tW = _derandomized_pair(tr1cs, tS, tck, 3, 1001)
    jpk, _ = JPP.setup(JPE, jck, jS)
    jproof = JPP.prove(JPE, jck, jpk, jS, jU, jW)
    tpk, tvk = TPP.setup(TPE, tck, tS)
    seen = []
    real = parallel.prove_cubic_with_three_inputs_sharded
    monkeypatch.setattr(parallel, "prove_cubic_with_three_inputs_sharded",
                        lambda *a: seen.append(1) or real(*a))
    with parallel.use_mesh(cpu_mesh(2)):
        tproof = TPP.prove(TPE, tck, tpk, tS, tU, tW)
    assert seen == [1] and counted_shard
    assert pp_fields(tproof) == pp_fields(jproof)
    tproof.verify(tvk, tU)
