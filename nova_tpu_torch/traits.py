"""Abstract trait layer (port of ``nova_tpu/traits.py``; reference:
src/traits/).

Python counterparts of the reference's trait hierarchy. Concrete classes
below are duck-typed throughout the library; these ABCs document the
required surface and are what the test matrix parameterizes over.

| Reference trait (src/traits/)      | Here                               |
|------------------------------------|------------------------------------|
| Engine (mod.rs:37-92)              | provider.engines.Engine            |
| ROTrait / ROCircuitTrait           | ROTrait / ROCircuitTrait           |
| TranscriptEngineTrait (mod.rs:202) | TranscriptEngineTrait              |
| CommitmentEngineTrait              | CommitmentEngineTrait              |
| EvaluationEngineTrait              | EvaluationEngineTrait              |
| RelaxedR1CSSNARKTrait (snark.rs)   | RelaxedR1CSSNARKTrait              |
| StepCircuit (circuit.rs:7-21)      | nova.circuit.StepCircuit           |
"""

from __future__ import annotations

import abc
from typing import Any, List, Sequence, Tuple


class ROTrait(abc.ABC):
    """Circuit-friendly random oracle (src/traits/mod.rs:107-133)."""

    @abc.abstractmethod
    def absorb(self, e: int) -> None: ...

    @abc.abstractmethod
    def squeeze(self, num_bits: int, start_with_one: bool = False) -> int: ...


class ROCircuitTrait(abc.ABC):
    """In-circuit RO (src/traits/mod.rs:136-179)."""

    @abc.abstractmethod
    def absorb(self, e) -> None: ...

    @abc.abstractmethod
    def squeeze(self, cs, num_bits: int, start_with_one: bool = False): ...


class TranscriptEngineTrait(abc.ABC):
    """Fiat-Shamir transcript (src/traits/mod.rs:202-229)."""

    @abc.abstractmethod
    def absorb(self, label: bytes, obj) -> None: ...

    @abc.abstractmethod
    def squeeze(self, label: bytes) -> int: ...

    @abc.abstractmethod
    def squeeze_bits(self, label: bytes, num_bits: int, start_with_one: bool) -> int: ...

    @abc.abstractmethod
    def dom_sep(self, tag: bytes) -> None: ...


class CommitmentEngineTrait(abc.ABC):
    """Vector commitments (src/traits/commitment.rs:52-195)."""

    @staticmethod
    @abc.abstractmethod
    def setup(curve, label: bytes, n: int): ...

    @staticmethod
    @abc.abstractmethod
    def commit(ck, v: Sequence[int], r: int): ...

    @staticmethod
    @abc.abstractmethod
    def commit_small(ck, v: Sequence[int], r: int): ...

    @staticmethod
    @abc.abstractmethod
    def commit_sparse(ck, indices: Sequence[int], scalars: Sequence[int], r: int): ...

    @staticmethod
    @abc.abstractmethod
    def derand_key(ck): ...

    @staticmethod
    @abc.abstractmethod
    def derandomize(dk, commit, r: int): ...


class EvaluationEngineTrait(abc.ABC):
    """Multilinear PCS open/verify (src/traits/evaluation.rs:11-46)."""

    @staticmethod
    @abc.abstractmethod
    def setup(engine, ck): ...

    @staticmethod
    @abc.abstractmethod
    def prove(engine, ck, pk, transcript, comm, poly, point, eval_v): ...

    @staticmethod
    @abc.abstractmethod
    def verify(engine, vk, transcript, comm, point, eval_v, arg): ...


class RelaxedR1CSSNARKTrait(abc.ABC):
    """Relaxed-R1CS SNARK with a ck sizing hint (src/traits/snark.rs:20-61)."""

    @staticmethod
    @abc.abstractmethod
    def ck_floor(S) -> int: ...

    @staticmethod
    @abc.abstractmethod
    def setup(engine, ck, S, ee=None): ...

    @staticmethod
    @abc.abstractmethod
    def prove(engine, ck, pk, S, U, W, ee=None): ...

    @abc.abstractmethod
    def verify(self, vk, U, ee=None) -> None: ...


def default_ck_hint() -> int:
    """src/traits/snark.rs default_ck_hint: no extra generators."""
    return 0


# Register the concrete implementations (kept as virtual subclasses so the
# concrete modules stay import-light).
def _register() -> None:
    from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as HKZG
    from nova_tpu_torch.provider.ipa import EvaluationEngine as IPA
    from nova_tpu_torch.provider.keccak import Keccak256Transcript
    from nova_tpu_torch.provider.mercury import EvaluationEngine as Mercury
    from nova_tpu_torch.provider.pedersen import CommitmentEngine
    from nova_tpu_torch.provider.poseidon import PoseidonRO
    from nova_tpu_torch.gadgets.poseidon_circuit import PoseidonROCircuit
    from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK as SpartanSNARK
    from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as PPSNARK

    ROTrait.register(PoseidonRO)
    ROCircuitTrait.register(PoseidonROCircuit)
    TranscriptEngineTrait.register(Keccak256Transcript)
    CommitmentEngineTrait.register(CommitmentEngine)
    EvaluationEngineTrait.register(IPA)
    RelaxedR1CSSNARKTrait.register(SpartanSNARK)
    RelaxedR1CSSNARKTrait.register(PPSNARK)
    EvaluationEngineTrait.register(HKZG)
    EvaluationEngineTrait.register(Mercury)


_register()
