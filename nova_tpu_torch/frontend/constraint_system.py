"""Constraint system core (reference: src/frontend/constraint_system.rs,
lc.rs, shape_cs.rs, util_cs/witness_cs.rs, r1cs.rs).

Variable indexing matches the reference exactly: z = [aux..., one, inputs...]
with input 0 = the constant one wire; in matrix columns, Input(i) maps to
column num_aux + i and Aux(i) to column i (src/frontend/r1cs.rs:105-122).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

from nova_tpu_torch.errors import AssignmentMissingError, SynthesisError
from nova_tpu_torch.fields.spec import FieldSpec

# A Variable is ('I'|'A', index); input 0 is the constant 1.
Variable = Tuple[str, int]
ONE: Variable = ("I", 0)


class LinearCombination:
    """Sparse LC with separate input/aux coefficient maps; iteration yields
    inputs (sorted) then aux (sorted), matching lc.rs iter()."""

    __slots__ = ("inputs", "aux")

    def __init__(self, inputs: Optional[Dict[int, int]] = None, aux: Optional[Dict[int, int]] = None):
        self.inputs = inputs if inputs is not None else {}
        self.aux = aux if aux is not None else {}

    @staticmethod
    def zero() -> "LinearCombination":
        return LinearCombination()

    @staticmethod
    def from_variable(var: Variable) -> "LinearCombination":
        return LinearCombination.zero().add_term(1, var)

    def copy(self) -> "LinearCombination":
        return LinearCombination(dict(self.inputs), dict(self.aux))

    def add_term(self, coeff: int, var: Variable) -> "LinearCombination":
        kind, idx = var
        d = self.inputs if kind == "I" else self.aux
        d[idx] = d.get(idx, 0) + coeff
        return self

    def sub_term(self, coeff: int, var: Variable) -> "LinearCombination":
        return self.add_term(-coeff, var)

    def add_lc(self, other: "LinearCombination", coeff: int = 1) -> "LinearCombination":
        for idx, c in other.inputs.items():
            self.inputs[idx] = self.inputs.get(idx, 0) + coeff * c
        for idx, c in other.aux.items():
            self.aux[idx] = self.aux.get(idx, 0) + coeff * c
        return self

    def scale(self, coeff: int) -> "LinearCombination":
        for d in (self.inputs, self.aux):
            for idx in d:
                d[idx] *= coeff
        return self

    def iter_terms(self):
        """Yield (var, coeff): inputs first (sorted), then aux (sorted)."""
        for idx in sorted(self.inputs):
            yield ("I", idx), self.inputs[idx]
        for idx in sorted(self.aux):
            yield ("A", idx), self.aux[idx]

    def eval(self, p: int, input_assignment: List[int], aux_assignment: List[int]) -> int:
        acc = 0
        for idx, c in self.inputs.items():
            acc += c * input_assignment[idx]
        for idx, c in self.aux.items():
            acc += c * aux_assignment[idx]
        return acc % p

    # convenience operators used by gadget code -------------------------

    def __add__(self, term):
        out = self.copy()
        if isinstance(term, LinearCombination):
            return out.add_lc(term)
        if isinstance(term, tuple) and len(term) == 2 and isinstance(term[0], int):
            coeff, var = term
            return out.add_term(coeff, var)
        return out.add_term(1, term)  # a Variable

    def __sub__(self, term):
        out = self.copy()
        if isinstance(term, LinearCombination):
            return out.add_lc(term, -1)
        if isinstance(term, tuple) and len(term) == 2 and isinstance(term[0], int):
            coeff, var = term
            return out.sub_term(coeff, var)
        return out.sub_term(1, term)


def lc(*terms) -> LinearCombination:
    """Build an LC from (coeff, var) tuples / Variables / LCs."""
    out = LinearCombination.zero()
    for t in terms:
        if isinstance(t, LinearCombination):
            out.add_lc(t)
        elif isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], int) and isinstance(t[1], tuple):
            out.add_term(t[0], t[1])
        else:
            out.add_term(1, t)
    return out


class ConstraintSystem:
    """Base CS over a FieldSpec. `one()` is input wire 0."""

    def __init__(self, field: FieldSpec):
        self.field = field

    @staticmethod
    def one() -> Variable:
        return ONE

    # interface: alloc, alloc_input, enforce
    def alloc(self, value) -> Variable:
        raise NotImplementedError

    def alloc_input(self, value) -> Variable:
        raise NotImplementedError

    def alloc2(self, value):
        """Allocate and also return the resolved raw value (var, v).
        Used by gadget wrappers that retain the value."""
        v = self._resolve(value)
        return self.alloc(v if v is not None else value), v

    def alloc_input2(self, value):
        v = self._resolve(value)
        return self.alloc_input(v if v is not None else value), v

    def enforce(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        raise NotImplementedError

    def bind(self, var: Variable, obj) -> None:
        """Associate a wrapper object with an allocated variable (used by
        witness tapes to refresh wrapper values on replay). No-op here."""

    def defer(self, thunk) -> None:
        """Run a side-effect thunk now (witness tapes also replay it)."""
        thunk()

    def is_witness_generator(self) -> bool:
        return False

    # True on systems that retain/validate constraints even while carrying
    # witness values (TestConstraintSystem); gates witness-only fast paths
    records_constraints = False

    @staticmethod
    def _resolve(value) -> Optional[int]:
        if callable(value):
            return value()
        return value


class ShapeCS(ConstraintSystem):
    """Collects constraints only (values ignored)
    — reference src/frontend/shape_cs.rs."""

    def __init__(self, field: FieldSpec):
        super().__init__(field)
        self.num_aux = 0
        self.num_inputs = 1  # the one wire
        self.constraints: List[Tuple[LinearCombination, LinearCombination, LinearCombination]] = []

    def alloc(self, value=None) -> Variable:
        v = ("A", self.num_aux)
        self.num_aux += 1
        return v

    def alloc_input(self, value=None) -> Variable:
        v = ("I", self.num_inputs)
        self.num_inputs += 1
        return v

    # shape collection never evaluates witness closures
    def alloc2(self, value):
        return self.alloc(None), None

    def alloc_input2(self, value):
        return self.alloc_input(None), None

    def enforce(self, a, b, c):
        self.constraints.append((a, b, c))

    def num_constraints(self) -> int:
        return len(self.constraints)

    def r1cs_shape(self):
        """Extract the R1CSShape (src/frontend/r1cs.rs:45-140): columns are
        [aux (num_aux), one, inputs]; entries appended in LC iteration
        order."""
        from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

        p = self.field.p
        num_vars = self.num_aux
        mats = []
        for sel in range(3):
            data, indices, indptr = [], [], [0]
            for cons in self.constraints:
                lc_ = cons[sel]
                for (kind, idx), coeff in lc_.iter_terms():
                    coeff %= p
                    if coeff == 0:
                        continue
                    col = idx + num_vars if kind == "I" else idx
                    data.append(coeff)
                    indices.append(col)
                indptr.append(len(data))
            mats.append(
                SparseMatrix(self.field, data, indices, indptr, num_vars + self.num_inputs)
            )
        return R1CSShape.new(
            self.field,
            len(self.constraints),
            num_vars,
            self.num_inputs - 1,
            *mats,
        )


class SatisfyingAssignment(ConstraintSystem):
    """Witness-only CS: stores assignments, ignores constraints
    (reference src/frontend/util_cs/witness_cs.rs)."""

    def __init__(self, field: FieldSpec):
        super().__init__(field)
        self.input_assignment: List[int] = [1]
        self.aux_assignment: List[int] = []

    def is_witness_generator(self) -> bool:
        return True

    def alloc(self, value) -> Variable:
        v = self._resolve(value)
        if v is None:
            raise AssignmentMissingError()
        self.aux_assignment.append(v % self.field.p)
        return ("A", len(self.aux_assignment) - 1)

    def alloc_input(self, value) -> Variable:
        v = self._resolve(value)
        if v is None:
            raise AssignmentMissingError()
        self.input_assignment.append(v % self.field.p)
        return ("I", len(self.input_assignment) - 1)

    def enforce(self, a, b, c):
        pass  # witness generation does not record constraints

    def r1cs_instance_and_witness(self, shape, ck, r_W=None):
        from nova_tpu_torch.r1cs import R1CSInstance, R1CSWitness

        W = R1CSWitness.new(shape, self.aux_assignment, r_W)
        X = self.input_assignment[1:]
        comm_W = W.commit(ck)
        return R1CSInstance.new(shape, comm_W, X), W


class TestConstraintSystem(ConstraintSystem):
    """Shape + witness simultaneously, with a satisfiability checker
    (reference src/frontend/util_cs/test_cs.rs)."""

    __test__ = False  # keep pytest from collecting this as a test class

    def __init__(self, field: FieldSpec):
        super().__init__(field)
        self.input_assignment: List[int] = [1]
        self.aux_assignment: List[int] = []
        self.constraints: List[Tuple[LinearCombination, LinearCombination, LinearCombination]] = []

    records_constraints = True

    def is_witness_generator(self) -> bool:
        return True

    def alloc(self, value) -> Variable:
        v = self._resolve(value)
        if v is None:
            raise AssignmentMissingError()
        self.aux_assignment.append(v % self.field.p)
        return ("A", len(self.aux_assignment) - 1)

    def alloc_input(self, value) -> Variable:
        v = self._resolve(value)
        if v is None:
            raise AssignmentMissingError()
        self.input_assignment.append(v % self.field.p)
        return ("I", len(self.input_assignment) - 1)

    def enforce(self, a, b, c):
        self.constraints.append((a, b, c))

    def num_constraints(self) -> int:
        return len(self.constraints)

    def is_satisfied(self) -> bool:
        p = self.field.p
        for a, b, c in self.constraints:
            av = a.eval(p, self.input_assignment, self.aux_assignment)
            bv = b.eval(p, self.input_assignment, self.aux_assignment)
            cv = c.eval(p, self.input_assignment, self.aux_assignment)
            if av * bv % p != cv:
                return False
        return True

    def which_is_unsatisfied(self):
        p = self.field.p
        for i, (a, b, c) in enumerate(self.constraints):
            av = a.eval(p, self.input_assignment, self.aux_assignment)
            bv = b.eval(p, self.input_assignment, self.aux_assignment)
            cv = c.eval(p, self.input_assignment, self.aux_assignment)
            if av * bv % p != cv:
                return i
        return None
