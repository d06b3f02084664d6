"""Entry points of the port (the twin of the repository's
``__graft_entry__.py``).

entry(device=None)  -> (fn, example_args): the single-device forward step on
                       the flagship compute path, msm1's program over 256
                       Pallas points at c = 8 with 8 rounds.
dryrun_multichip(n_devices, devices=None)
                    -> build an n-device mesh and run the dryrun's checks:
                       a sharded commit, a NIFS fold under the mesh, the
                       sharded outer sumcheck, a RecursiveSNARK under the
                       mesh, and the sharded fold drill.

Both run on CUDA unless the caller names other devices; nothing falls back
to the CPU. On the CPU (the plain versions):

    python -c "from nova_tpu_torch.graft_entry import dryrun_multichip; \\
               dryrun_multichip(8, devices=['cpu'] * 8)"
"""

from __future__ import annotations

import os
import random

ENTRY_POINTS, ENTRY_WINDOW, ENTRY_ROUNDS, ENTRY_SEED = 256, 8, 8, 42


def entry_inputs():
    """entry()'s scalars and bases: ENTRY_POINTS scalars from
    random.Random(ENTRY_SEED) over the doubling chain G, 2G, 4G, ... of
    Pallas."""
    from nova_tpu_torch.curves.spec import AffinePoint, pallas

    rng = random.Random(ENTRY_SEED)
    bases, acc = [], AffinePoint.generator(pallas)
    for _ in range(ENTRY_POINTS):
        bases.append(acc)
        acc = acc.double()
    scalars = [rng.randrange(pallas.scalar.p) for _ in range(ENTRY_POINTS)]
    return scalars, bases


def entry(device=None):
    """(fn, args): fn(*args) runs msm1's program (ops/msm.py) on the entry
    inputs, marshalled on `device` (CUDA unless given), and returns
    (x, y, zz, zzz), each (16,) standard-form limbs of the XYZZ sum."""
    import numpy as np
    import torch

    from nova_tpu_torch._device import resolve
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops.msm import (
        DeviceBases,
        digits_for_windows,
        msm_program,
        scalars_to_limbs16,
    )

    dev = resolve(device)
    scalars, bases = entry_inputs()
    c = ENTRY_WINDOW
    num_windows = (pallas.scalar.num_bits + c - 1) // c
    digits = digits_for_windows(scalars_to_limbs16(scalars), c, num_windows)
    db = DeviceBases(pallas, bases, device=dev)
    tf = TField(pallas.base)

    def fn(d_all, bx, by, binf):
        return msm_program(tf, c, ENTRY_ROUNDS, d_all, bx, by, binf)

    return fn, (torch.from_numpy(digits.astype(np.int64)).to(dev), db.x, db.y, db.inf)


def _wide_cubic_shape(f, num_vars: int):
    """The tiny cubic R1CS x^3 + x + 5 = y (src/r1cs/mod.rs:1294-1358),
    widened to `num_vars` witness entries."""
    from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

    num_cons, num_io = 4, 2
    # z = (W, 1, x, y): the constant at column num_vars, then the io
    one, x, y = num_vars, num_vars + 1, num_vars + 2
    A = [(0, x, 1), (1, 0, 1), (2, 1, 1), (2, x, 1), (3, 2, 1), (3, one, 5)]
    B = [(0, x, 1), (1, x, 1), (2, one, 1), (3, one, 1)]
    C = [(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, y, 1)]
    rows, cols = num_cons, num_vars + num_io + 1
    return R1CSShape.new(f, num_cons, num_vars, num_io,
                         SparseMatrix.new(f, A, rows, cols),
                         SparseMatrix.new(f, B, rows, cols),
                         SparseMatrix.new(f, C, rows, cols))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """A real NIFS fold step (src/nova/nifs.rs:36-73) on the tiny cubic
    R1CS with every commitment MSM sharded over an n_devices mesh (the
    first n of `devices`, all CUDA devices by default), and the checks:
    (a) a sharded commit equals the host commit bit for bit; (b) the fold
    under the mesh equals the unsharded fold, and the folded pair is
    satisfied; (c) the sharded outer sumcheck's proof, r and claims equal
    the host prover's under NOVA_NO_GRUEN=1; (d) a TrivialCircuit
    RecursiveSNARK takes two prove_steps under the mesh (the first only
    bumps the counter, the second folds, its witness commits sharded) and
    verifies; then the sharded fold drill. Raises AssertionError on a
    mismatch. Returns {"mesh", "pp", "rs", "circuit", "fold_commit"}."""
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.nova.circuit import TrivialCircuit
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.nova.nifs import NIFS
    from nova_tpu_torch.parallel import (
        make_mesh,
        msm_sharded,
        prove_cubic_with_three_inputs_sharded,
        run_sharded_fold_step,
        use_mesh,
    )
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine
    from nova_tpu_torch.provider.keccak import Keccak256Transcript
    from nova_tpu_torch.provider.pedersen import CommitmentEngine
    from nova_tpu_torch.r1cs import (
        R1CSInstance,
        R1CSWitness,
        RelaxedR1CSInstance,
        RelaxedR1CSWitness,
    )
    from nova_tpu_torch.spartan.polys import MultilinearPolynomial
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.devices[0]
    engine = PallasEngine
    f = engine.scalar

    # the cubic R1CS widened so witness commits have a point per device
    num_vars = max(8 * n_devices, 64)
    S = _wide_cubic_shape(f, num_vars)
    ck = S.commitment_key(device=dev)

    def pair(x):
        z0 = f.mul(x, x)
        z1 = f.mul(z0, x)
        z2 = f.add(z1, x)
        W = R1CSWitness.new(S, [z0, z1, z2] + [0] * (num_vars - 3), r_W=7)
        return R1CSInstance.new(S, W.commit(ck), [x, f.add(z2, 5)]), W

    # (a) sharded commit == host commit, bit for bit
    _, W1 = pair(5)
    host_comm = CommitmentEngine.commit(ck, W1.W, W1.r_W)
    shard_pt = msm_sharded(list(W1.W), ck.ck[: len(W1.W)], mesh=mesh).add(ck.h.mul(W1.r_W))
    assert (shard_pt.x, shard_pt.y) == (host_comm.point.x, host_comm.point.y), \
        "sharded MSM differs from the host commit"

    # (b) a real fold with every commit sharded, against the same fold
    # without the mesh
    r_U = RelaxedR1CSInstance.default(engine.curve, S)
    r_W = RelaxedR1CSWitness.default(S)
    pp_digest = 0x1234
    with use_mesh(mesh):
        U2, W2 = pair(9)
        _, (U_f, W_f) = NIFS.prove(ck, engine, pp_digest, S, r_U, r_W, U2, W2, r_T=11)
    S.is_sat_relaxed(ck, U_f, W_f)
    _, (U_h, _) = NIFS.prove(ck, engine, pp_digest, S, r_U, r_W, U2, W2, r_T=11)
    assert U_f.comm_W == U_h.comm_W and U_f.comm_E == U_h.comm_E, "meshed fold differs"
    assert U_f.u == U_h.u and U_f.X == U_h.X, "meshed fold differs"

    # (c) the sharded outer sumcheck == the host prover (materialized eq),
    # proof bit for bit, on tables whose claim is 0 (C = A*B pointwise)
    rng = random.Random(0x5C)
    k = max(6, n_devices.bit_length() + 2)
    p = f.p
    taus = [rng.randrange(p) for _ in range(k)]
    Az = [rng.randrange(p) for _ in range(1 << k)]
    Bz = [rng.randrange(p) for _ in range(1 << k)]
    Cz = [a * b % p for a, b in zip(Az, Bz)]
    proof_s, rx_s, claims_s = prove_cubic_with_three_inputs_sharded(
        f, 0, taus, Az, Bz, Cz, Keccak256Transcript(b"dryrun", f), mesh)
    before = os.environ.get("NOVA_NO_GRUEN")
    os.environ["NOVA_NO_GRUEN"] = "1"
    try:
        proof_h, rx_h, claims_h = SumcheckProof.prove_cubic_with_three_inputs(
            f, 0, taus, *(MultilinearPolynomial(f, list(t)) for t in (Az, Bz, Cz)),
            Keccak256Transcript(b"dryrun", f))
    finally:
        if before is None:
            del os.environ["NOVA_NO_GRUEN"]
        else:
            os.environ["NOVA_NO_GRUEN"] = before
    assert rx_s == rx_h and claims_s == claims_h, "sharded sumcheck diverges"
    assert ([pl.coeffs_except_linear_term for pl in proof_s.compressed_polys]
            == [pl.coeffs_except_linear_term for pl in proof_h.compressed_polys]), \
        "sharded sumcheck proof bits differ"

    # (d) a RecursiveSNARK on the trivial circuit under the mesh verifies
    circuit = TrivialCircuit()
    pp = PublicParams.setup(PallasEngine, VestaEngine, circuit, device=dev)
    rs = RecursiveSNARK.new(pp, circuit, [0])
    with use_mesh(mesh):
        rs.prove_step(pp, circuit)
        rs.prove_step(pp, circuit)
    rs.verify(pp, rs.i, [0])

    # the sharded fold drill (elementwise fold, exact partial sums, a
    # sharded commit)
    fold_commit = run_sharded_fold_step(mesh, pallas.base, max(8 * n_devices, 64))
    return {"mesh": mesh, "pp": pp, "rs": rs, "circuit": circuit,
            "fold_commit": fold_commit}
