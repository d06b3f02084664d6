"""NeutronNova IVC (experimental; port of ``nova_tpu/neutron/ivc.py``;
reference: src/neutron/mod.rs).

Single-curve IVC: each step folds the last R1CS instance into a running
FoldedInstance via the zero-fold NIFS; the augmented circuit carries the
in-circuit verifier. The reference gates this behind `experimental` and
documents missing checks (mod.rs:2) — mirrored here.

``prove_step`` marks its phases for ``profiling`` (NOVA_PROFILE=1):
neutron_nifs, neutron_synthesize (the whole augmented circuit, every
step: there is no witness tape) and neutron_commit.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Sequence

from nova_tpu_torch import profiling
from nova_tpu_torch._device import resolve
from nova_tpu_torch.constants import NUM_HASH_BITS
from nova_tpu_torch.digest import DigestComputer, _u64, map_to_field
from nova_tpu_torch.errors import (
    InvalidInitialInputLengthError,
    InvalidStepCircuitIOError,
    ProofVerifyError,
)
from nova_tpu_torch.frontend.constraint_system import SatisfyingAssignment, ShapeCS
from nova_tpu_torch.neutron import FoldedInstance, FoldedWitness, NIFS, Structure
from nova_tpu_torch.neutron.circuit import (
    NeutronAugmentedCircuit,
    NeutronAugmentedCircuitInputs,
)
from nova_tpu_torch.provider.poseidon import PoseidonROConstants


class PublicParams:
    """src/neutron/mod.rs:36-227."""

    def __init__(self, engine1, engine2, F_arity, ck, structure):
        self.engine1 = engine1
        self.engine2 = engine2
        self.F_arity = F_arity
        self.ck = ck
        self.structure = structure
        self.ro_consts = PoseidonROConstants(engine1.scalar)
        self._digest = None

    @staticmethod
    def setup(engine1, engine2, c, ck_hint1: int = 0, device=None) -> "PublicParams":
        """Synthesize the augmented circuit with a ShapeCS and derive its
        commitment key for `device` (CUDA unless given)."""
        device = resolve(device)
        F_arity = c.arity()
        ro_consts_circuit = PoseidonROConstants(engine1.scalar)
        cs = ShapeCS(engine1.scalar)
        NeutronAugmentedCircuit(None, c, ro_consts_circuit).synthesize(cs)
        shape = cs.r1cs_shape()
        if shape.num_io != 1:
            raise InvalidStepCircuitIOError()
        ck = shape.commitment_key(b"ck", ck_hint1, device=device)
        structure = Structure(shape)
        pp = PublicParams(engine1, engine2, F_arity, ck, structure)
        pp.digest()
        return pp

    def digest(self) -> int:
        if self._digest is None:
            h = hashlib.sha3_256()
            h.update(b"nova_tpu.neutron.PublicParams")
            h.update(self.engine1.name.encode())
            h.update(_u64(self.F_arity))
            S = self.structure.S
            h.update(_u64(S.num_cons))
            h.update(_u64(S.num_vars))
            h.update(_u64(S.num_io))
            for M in (S.A, S.B, S.C):
                h.update(DigestComputer.digest_bytes_sparse(M))
            h.update(_u64(len(self.ck.ck)))
            self._digest = map_to_field(h.digest(), self.engine1.scalar)
        return self._digest


class RecursiveSNARK:
    """src/neutron/mod.rs:230-443."""

    def __init__(self, z0, r_W, r_U, ri, l_w, l_u, i, zi):
        self.z0 = list(z0)
        self.r_W = r_W
        self.r_U = r_U
        self.ri = ri
        self.l_w = l_w
        self.l_u = l_u
        self.i = i
        self.zi = list(zi)

    @staticmethod
    def new(pp: PublicParams, c, z0: Sequence[int]) -> "RecursiveSNARK":
        if len(z0) != pp.F_arity:
            raise InvalidInitialInputLengthError()
        e1 = pp.engine1
        ri = secrets.randbelow(e1.scalar.p)

        cs = SatisfyingAssignment(e1.scalar)
        inputs = NeutronAugmentedCircuitInputs(
            pp_digest=pp.digest(), i=0, z0=list(z0), r_next=ri
        )
        zi_nums = NeutronAugmentedCircuit(inputs, c, pp.ro_consts).synthesize(cs)
        l_u, l_w = cs.r1cs_instance_and_witness(pp.structure.S, pp.ck)
        assert len(zi_nums) == pp.F_arity

        return RecursiveSNARK(
            z0=z0,
            r_W=FoldedWitness.default(pp.structure),
            r_U=FoldedInstance.default(e1.curve, pp.structure),
            ri=ri,
            l_w=l_w,
            l_u=l_u,
            i=0,
            zi=[n.get_value() for n in zi_nums],
        )

    def prove_step(self, pp: PublicParams, c) -> None:
        if self.i == 0:
            self.i = 1
            return
        e1 = pp.engine1

        with profiling.phase("neutron_nifs"):
            nifs, (r_U, r_W) = NIFS.prove(
                pp.ck, e1, pp.digest(), pp.structure,
                self.r_U, self.r_W, self.l_u, self.l_w,
            )

        r_next = secrets.randbelow(e1.scalar.p)
        cs = SatisfyingAssignment(e1.scalar)
        inputs = NeutronAugmentedCircuitInputs(
            pp_digest=pp.digest(),
            i=self.i,
            z0=list(self.z0),
            zi=list(self.zi),
            U=self.r_U,
            ri=self.ri,
            r_next=r_next,
            u=self.l_u,
            nifs=nifs,
            comm_W_fold=r_U.comm_W,
            comm_E_fold=r_U.comm_E,
        )
        with profiling.phase("neutron_synthesize"):
            zi_nums = NeutronAugmentedCircuit(inputs, c, pp.ro_consts).synthesize(cs)
        with profiling.phase("neutron_commit"):
            l_u, l_w = cs.r1cs_instance_and_witness(pp.structure.S, pp.ck)

        self.zi = [n.get_value() for n in zi_nums]
        self.r_U = r_U
        self.r_W = r_W
        self.i += 1
        self.ri = r_next
        self.l_u = l_u
        self.l_w = l_w

    def verify(self, pp: PublicParams, num_steps: int, z0: Sequence[int]) -> List[int]:
        if (
            num_steps == 0
            or self.i != num_steps
            or list(self.z0) != list(z0)
            or len(self.l_u.X) != 1
            or len(self.r_U.X) != 1
        ):
            raise ProofVerifyError("Invalid number of steps or inputs")

        e1 = pp.engine1
        hasher = e1.new_ro2()
        hasher.absorb(pp.digest())
        hasher.absorb(num_steps)
        for e in z0:
            hasher.absorb(e)
        for e in self.zi:
            hasher.absorb(e)
        self.r_U.absorb_in_ro2(hasher)
        hasher.absorb(self.ri)
        h = hasher.squeeze(NUM_HASH_BITS, False)

        if h != self.l_u.X[0]:
            raise ProofVerifyError("Invalid output hash in R1CS instance")

        pp.structure.is_sat(pp.ck, self.r_U, self.r_W)
        pp.structure.S.is_sat(pp.ck, self.l_u, self.l_w)
        return list(self.zi)

    def outputs(self):
        return list(self.zi)

    def num_steps(self):
        return self.i
