"""Compiled witness generation via trace-and-replay tapes.

The reference synthesizes its ~10k-constraint augmented circuits
imperatively every IVC step and ships a dedicated vectorized witness
generator for its hot gadget (Poseidon,
the reference's src/frontend/gadgets/poseidon/circuit2_witness.rs).
SURVEY.md §7 hard-part 5 generalizes that idea: compile each circuit ONCE
into a replayable witness program so the per-step cost is pure value
arithmetic with no constraint-system bookkeeping (no LinearCombination
dict churn, no namespace/object allocation, no enforce calls).

Design
------
`TapeCS` is a witness-generating ConstraintSystem that records, for every
allocation whose value is a *callable*, the closure itself plus the target
slot and (optionally) the gadget wrapper object bound to that slot.
Gadget code follows the bellpepper discipline: value closures read ONLY
the `.value` of previously allocated wrappers (AllocatedNum/AllocatedBit)
or lazily-resolved metadata (`Lazy`, lazy `Num`, BigNat values), never
hoisted locals. Replaying the tape with fresh circuit inputs therefore
re-executes only the value closures, in allocation order, updating the
retained object graph as it goes — data-dependent Python branches inside
closures re-run naturally with the new values.

Raw (non-callable) values are treated as step-independent constants and
are skipped on replay.

`Lazy` provides epoch-memoized derived values (e.g. BigNat naturals,
Poseidon MDS accumulators) so body-computed metadata stays fresh across
replays without exponential recompute of deep lazy chains.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from nova_tpu_torch.errors import AssignmentMissingError
from nova_tpu_torch.frontend.constraint_system import ConstraintSystem

# Global replay epoch: bumped once per tape replay; Lazy values memoize
# against it. Single-threaded by assumption (as is the whole frontend).
EPOCH = 0

# True while a TapeCS synthesis (trace) is running. Gadget code uses this
# to route derived metadata through Lazy cells instead of eager ints.
TRACING = False


class Lazy:
    """An epoch-memoized thunk. `get()` recomputes at most once per tape
    replay epoch."""

    __slots__ = ("fn", "_epoch", "_cache")

    def __init__(self, fn: Callable):
        self.fn = fn
        self._epoch = -1
        self._cache = None

    def get(self):
        if self._epoch != EPOCH:
            self._cache = self.fn()
            self._epoch = EPOCH
        return self._cache


def resolve(v):
    """Resolve a value that may be an int/None, a Lazy, or a callable."""
    if isinstance(v, Lazy):
        return v.get()
    if callable(v):
        return v()
    return v


class TapeCS(ConstraintSystem):
    """Witness generator that records a replayable tape.

    Tape entries are tuples (kind, fn, slot, wrapper):
      kind 0: aux slot      — aux_assignment[slot] = fn() % p
      kind 1: input slot    — input_assignment[slot] = fn() % p
      kind 2: deferred thunk — fn() for side effects (slot/wrapper unused)
    Wrapper objects (AllocatedNum/AllocatedBit) bound via `bind` receive
    the *raw* closure result (bools stay bools)."""

    AUX, INP, THUNK = 0, 1, 2

    def __init__(self, field):
        super().__init__(field)
        self.input_assignment: List[int] = [1]
        self.aux_assignment: List[int] = []
        self.entries: list = []
        # slot -> tape entry index, for late wrapper binding
        self._aux_entry = {}
        self._inp_entry = {}

    def is_witness_generator(self) -> bool:
        return True

    # -- trace-time allocation ------------------------------------------

    def alloc2(self, value):
        if callable(value):
            v = value()
            if v is None:
                raise AssignmentMissingError()
            slot = len(self.aux_assignment)
            self.aux_assignment.append(v % self.field.p)
            self._aux_entry[slot] = len(self.entries)
            self.entries.append([TapeCS.AUX, value, slot, None])
            return ("A", slot), v
        if value is None:
            raise AssignmentMissingError()
        slot = len(self.aux_assignment)
        self.aux_assignment.append(value % self.field.p)
        return ("A", slot), value

    def alloc(self, value):
        return self.alloc2(value)[0]

    def alloc_input2(self, value):
        if callable(value):
            v = value()
            if v is None:
                raise AssignmentMissingError()
            slot = len(self.input_assignment)
            self.input_assignment.append(v % self.field.p)
            self._inp_entry[slot] = len(self.entries)
            self.entries.append([TapeCS.INP, value, slot, None])
            return ("I", slot), v
        if value is None:
            raise AssignmentMissingError()
        slot = len(self.input_assignment)
        self.input_assignment.append(value % self.field.p)
        return ("I", slot), value

    def alloc_input(self, value):
        return self.alloc_input2(value)[0]

    def bind(self, var, obj):
        """Associate a wrapper object with an allocated slot so replay can
        refresh its .value. No-op for constant slots."""
        kind, idx = var
        table = self._aux_entry if kind == "A" else self._inp_entry
        ei = table.get(idx)
        if ei is not None:
            self.entries[ei][3] = obj

    def defer(self, thunk: Callable):
        """Run a side-effect thunk now and on every replay (in order)."""
        thunk()
        self.entries.append([TapeCS.THUNK, thunk, 0, None])

    def enforce(self, a, b, c):
        pass

    # -- replay ----------------------------------------------------------

    def replay(self):
        """Re-execute every recorded closure with the current circuit
        inputs, refreshing assignments and bound wrappers in order."""
        global EPOCH
        EPOCH += 1
        p = self.field.p
        aux = self.aux_assignment
        inp = self.input_assignment
        AUX = TapeCS.AUX
        INP = TapeCS.INP
        for e in self.entries:
            kind = e[0]
            if kind == AUX:
                v = e[1]()
                aux[e[2]] = v % p
                obj = e[3]
                if obj is not None:
                    obj.value = v  # raw, mirroring trace-time wrapper state
            elif kind == INP:
                v = e[1]()
                inp[e[2]] = v % p
                obj = e[3]
                if obj is not None:
                    obj.value = v
            else:
                e[1]()

    # -- extraction ------------------------------------------------------

    def r1cs_instance_and_witness(self, shape, ck, r_W=None):
        from nova_tpu_torch.r1cs import R1CSInstance, R1CSWitness

        W = R1CSWitness.new(shape, list(self.aux_assignment), r_W)
        X = list(self.input_assignment[1:])
        comm_W = W.commit(ck)
        return R1CSInstance.new(shape, comm_W, X), W


class trace_mode:
    """Context manager setting the global TRACING flag during a trace."""

    def __enter__(self):
        global TRACING
        self._prev = TRACING
        TRACING = True
        return self

    def __exit__(self, *exc):
        global TRACING
        TRACING = self._prev
        return False
