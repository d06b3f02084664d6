"""Non-interactive folding scheme (reference: src/nova/nifs.rs).

NIFS.prove folds an incoming plain R1CS instance/witness into the running
relaxed instance/witness; the proof is the single cross-term commitment
comm_T. The challenge r comes from the Poseidon RO over the BASE field
(coordinates of commitments live there), then is bit-copied into the scalar
field (base_as_scalar, 128-bit challenges; src/nova/nifs.rs:36-107).

U1 is NOT absorbed in the plain variant: the IVC wiring guarantees
U2.X[0] = H(params, U1, i, z0, zi), binding U1 transitively
(src/nova/nifs.rs:31-35). The relaxed variant absorbs both (used when
folding the ZK randomizer instance).

Both take the cross-term from ``R1CSShape.cross_term``, which hands back the
incoming witness as the witness fold should read it: for a shape of at least
FOLD_DEVICE_THRESHOLD rows, with its vectors on the device, converted once."""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Tuple

from nova_tpu_torch import profiling
from nova_tpu_torch.constants import NUM_CHALLENGE_BITS
from nova_tpu_torch.provider.engines import Engine
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentKey
from nova_tpu_torch.r1cs import (
    R1CSInstance,
    R1CSShape,
    R1CSWitness,
    RelaxedR1CSInstance,
    RelaxedR1CSWitness,
)


@dataclass
class NIFS:
    comm_T: Commitment

    @staticmethod
    def prove(
        ck: CommitmentKey,
        engine: Engine,
        pp_digest: int,
        S: R1CSShape,
        U1: RelaxedR1CSInstance,
        W1: RelaxedR1CSWitness,
        U2: R1CSInstance,
        W2: R1CSWitness,
        r_T: int = None,
    ) -> Tuple["NIFS", Tuple[RelaxedR1CSInstance, RelaxedR1CSWitness]]:
        with profiling.phase("nifs.ro"):
            ro = engine.new_ro()
            ro.absorb(pp_digest)
            U2.absorb_in_ro(ro)
        if r_T is None:
            r_T = secrets.randbelow(engine.scalar.p)
        T, comm_T, W2 = S.cross_term(ck, U1, W1, U2, W2, r_T, relaxed=False)
        with profiling.phase("nifs.ro"):
            comm_T.absorb_in_ro(ro)
            r = ro.squeeze(NUM_CHALLENGE_BITS)
        with profiling.phase("nifs.fold"):
            U = U1.fold(engine.scalar, U2, comm_T, r)
            W = W1.fold(engine.scalar, W2, T, r_T, r)
        return NIFS(comm_T), (U, W)

    def verify(
        self,
        engine: Engine,
        pp_digest: int,
        U1: RelaxedR1CSInstance,
        U2: R1CSInstance,
    ) -> RelaxedR1CSInstance:
        ro = engine.new_ro()
        ro.absorb(pp_digest)
        U2.absorb_in_ro(ro)
        self.comm_T.absorb_in_ro(ro)
        r = ro.squeeze(NUM_CHALLENGE_BITS)
        return U1.fold(engine.scalar, U2, self.comm_T, r)


@dataclass
class NIFSRelaxed:
    comm_T: Commitment

    @staticmethod
    def prove(
        ck: CommitmentKey,
        engine: Engine,
        pp_digest: int,
        S: R1CSShape,
        U1: RelaxedR1CSInstance,
        W1: RelaxedR1CSWitness,
        U2: RelaxedR1CSInstance,
        W2: RelaxedR1CSWitness,
        r_T: int = None,
    ) -> Tuple["NIFSRelaxed", Tuple[RelaxedR1CSInstance, RelaxedR1CSWitness]]:
        with profiling.phase("nifs.ro"):
            ro = engine.new_ro()
            ro.absorb(pp_digest)
            U1.absorb_in_ro(ro)
            U2.absorb_in_ro(ro)
        if r_T is None:
            r_T = secrets.randbelow(engine.scalar.p)
        T, comm_T, W2 = S.cross_term(ck, U1, W1, U2, W2, r_T, relaxed=True)
        with profiling.phase("nifs.ro"):
            comm_T.absorb_in_ro(ro)
            r = ro.squeeze(NUM_CHALLENGE_BITS)
        with profiling.phase("nifs.fold"):
            U = U1.fold_relaxed(engine.scalar, U2, comm_T, r)
            W = W1.fold_relaxed(engine.scalar, W2, T, r_T, r)
        return NIFSRelaxed(comm_T), (U, W)

    def verify(
        self,
        engine: Engine,
        pp_digest: int,
        U1: RelaxedR1CSInstance,
        U2: RelaxedR1CSInstance,
    ) -> RelaxedR1CSInstance:
        ro = engine.new_ro()
        ro.absorb(pp_digest)
        U1.absorb_in_ro(ro)
        U2.absorb_in_ro(ro)
        self.comm_T.absorb_in_ro(ro)
        r = ro.squeeze(NUM_CHALLENGE_BITS)
        return U1.fold_relaxed(engine.scalar, U2, self.comm_T, r)
