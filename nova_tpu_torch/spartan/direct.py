"""DirectSNARK: prove a single step circuit without IVC (port of
``nova_tpu/spartan/direct.py``; reference: src/spartan/direct.rs).

Wraps the step circuit in a DirectCircuit that inputizes (z_i, z_{i+1}),
commits the witness with a fresh blind, derandomizes, and runs any
Relaxed-R1CS SNARK on the relaxed form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from nova_tpu_torch._device import resolve
from nova_tpu_torch.frontend.constraint_system import SatisfyingAssignment, ShapeCS
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.provider.pedersen import CommitmentEngine as CE
from nova_tpu_torch.r1cs import RelaxedR1CSInstance, RelaxedR1CSWitness
from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK


class DirectCircuit:
    """Inputize z_i and z_{i+1} around a step circuit
    (src/spartan/direct.rs:29-69)."""

    def __init__(self, z_i: Optional[List[int]], sc):
        self.z_i = z_i
        self.sc = sc

    def synthesize(self, cs) -> None:
        arity = self.sc.arity()
        zi_vals = self.z_i if self.z_i is not None else [0] * arity
        z_i = [AllocatedNum.alloc(cs, zi_vals[j]) for j in range(arity)]
        z_next = self.sc.synthesize(cs, z_i)
        for v in z_i:
            v.inputize(cs)
        for v in z_next:
            v.inputize(cs)


@dataclass
class DirectProverKey:
    S: object
    ck: object
    pk: object


@dataclass
class DirectVerifierKey:
    dk: object
    vk: object


class DirectSNARK:
    """src/spartan/direct.rs:106-200."""

    def __init__(self, comm_W, blind_r_W, snark):
        self.comm_W = comm_W
        self.blind_r_W = blind_r_W
        self.snark = snark

    @staticmethod
    def setup(engine, sc, S_snark=None, device=None):
        """Keys for `sc`; the commitment key's device MSMs run on `device`
        (CUDA unless given)."""
        S_snark = S_snark or RelaxedR1CSSNARK
        device = resolve(device)
        cs = ShapeCS(engine.scalar)
        DirectCircuit(None, sc).synthesize(cs)
        shape = cs.r1cs_shape()
        ck = shape.commitment_key(b"ck", S_snark.ck_floor(shape), device=device)
        pk_s, vk_s = S_snark.setup(engine, ck, shape)
        return (
            DirectProverKey(shape, ck, pk_s),
            DirectVerifierKey(CE.derand_key(ck), vk_s),
        )

    @staticmethod
    def prove(engine, pk: DirectProverKey, sc, z_i: Sequence[int], S_snark=None):
        S_snark = S_snark or RelaxedR1CSSNARK
        cs = SatisfyingAssignment(engine.scalar)
        DirectCircuit(list(z_i), sc).synthesize(cs)
        u, w = cs.r1cs_instance_and_witness(pk.S, pk.ck)

        u_relaxed = RelaxedR1CSInstance.from_r1cs_instance_unchecked(
            engine.curve, pk.S, u.comm_W, u.X
        )
        w_relaxed = RelaxedR1CSWitness.from_r1cs_witness(pk.S, w)

        derandom_w, blind_W, blind_E = w_relaxed.derandomize()
        derandom_u = u_relaxed.derandomize(CE.derand_key(pk.ck), blind_W, blind_E)

        snark = S_snark.prove(engine, pk.ck, pk.pk, pk.S, derandom_u, derandom_w)
        return DirectSNARK(u.comm_W, w_relaxed.r_W, snark)

    def verify(self, engine, vk: DirectVerifierKey, io: Sequence[int], shape=None) -> None:
        comm_W = CE.derandomize(vk.dk, self.comm_W, self.blind_r_W)
        u_relaxed = RelaxedR1CSInstance.from_r1cs_instance_unchecked(
            engine.curve, None, comm_W, list(io)
        )
        self.snark.verify(vk.vk, u_relaxed)
