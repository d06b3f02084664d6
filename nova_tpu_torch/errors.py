"""Error types (reference: src/errors.rs)."""


class NovaError(Exception):
    """Base error for nova_tpu_torch."""


class InvalidIndexError(NovaError):
    """An index is out of bounds (reference: NovaError::InvalidIndex)."""


class InvalidInputLengthError(NovaError):
    """Public IO has the wrong length (NovaError::InvalidInputLength)."""


class InvalidWitnessLengthError(NovaError):
    """Witness vector has the wrong length (NovaError::InvalidWitnessLength)."""


class UnSatError(NovaError):
    """An instance/witness pair does not satisfy its shape (NovaError::UnSat)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class TapeReplayError(UnSatError):
    """A witness produced by replaying a compiled tape
    (frontend/tape.py) does not satisfy the circuit's R1CS. Almost
    always a tape-discipline violation in the step circuit: synthesize()
    computed a value eagerly in the function body, or its Python control
    flow / allocation structure depends on step values, so the recorded
    trace is stale for this step. Set `tape_safe = False` on the step
    circuit to use interpreted synthesis, or restructure allocations as
    closures (see StepCircuit docstring, nova/circuit.py)."""


class InvalidInitialInputLengthError(NovaError):
    """z0 length differs from the step circuit arity
    (NovaError::InvalidInitialInputLength)."""


class InvalidStepOutputLengthError(NovaError):
    """Step circuit returned the wrong number of outputs
    (NovaError::InvalidStepOutputLength)."""


class InvalidStepCircuitIOError(NovaError):
    """Augmented circuit did not produce exactly 2 public IO values
    (NovaError::InvalidStepCircuitIO)."""


class ProofVerifyError(NovaError):
    """A proof failed verification (NovaError::ProofVerifyError)."""


class InvalidSumcheckProofError(NovaError):
    """A sumcheck proof failed verification."""


class InternalError(NovaError):
    """Internal invariant violation (NovaError::InternalError)."""


class InvalidCommitmentKeyLengthError(NovaError):
    """Commitment key too short (NovaError::InvalidCommitmentKeyLength)."""


class PtauFileError(NovaError):
    """Error reading/writing a powers-of-tau file."""


class SynthesisError(NovaError):
    """Constraint-system synthesis error (frontend, reference
    src/frontend/constraint_system.rs SynthesisError)."""


class AssignmentMissingError(SynthesisError):
    """A variable assignment was requested but missing."""


class UnconstrainedError(SynthesisError):
    """A variable was never used in a constraint."""
