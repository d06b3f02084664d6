"""R1CS constraint-system frontend (reference: src/frontend/, a bellpepper
port — src/frontend/mod.rs:3).

The DSL builds shapes once (ShapeCS) and generates witnesses per step
(SatisfyingAssignment). Synthesis is host-side Python — like the Rust
reference, circuit synthesis is inherently sequential pointer-chasing
(SURVEY.md §3.5 hot-loop 5); the device-facing artifact is the resulting CSR
shape + witness vectors, which feed the device kernels."""

from nova_tpu_torch.frontend.constraint_system import (
    Variable,
    LinearCombination,
    ConstraintSystem,
    ShapeCS,
    SatisfyingAssignment,
    TestConstraintSystem,
)
from nova_tpu_torch.frontend.num import AllocatedNum, Num
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean

__all__ = [
    "Variable",
    "LinearCombination",
    "ConstraintSystem",
    "ShapeCS",
    "SatisfyingAssignment",
    "TestConstraintSystem",
    "AllocatedNum",
    "Num",
    "AllocatedBit",
    "Boolean",
]
