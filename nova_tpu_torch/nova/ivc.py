"""Nova IVC engine: PublicParams + RecursiveSNARK (port of
``nova_tpu/nova/ivc.py``; reference: src/nova/mod.rs).

Both commitment keys live on the device given to ``PublicParams.setup``
or ``PublicParams.setup_with_ptau_dir`` (CUDA unless the caller passes
another); every device route of the fold step (the int-scalar and
fixed-base MSMs, SpMV, FVec folds) runs there.

The two-curve cycle: the primary augmented circuit lives over E1::Scalar and
manipulates points of E2's curve (whose base field is E1::Scalar); vice versa
for the secondary. Each augmented circuit exposes exactly two public IO
values — hashes of the running instances (src/nova/mod.rs:156-160).

Field-switch (scalar_as_base / base_as_scalar) is a bit-copy: hash outputs
are 250-bit, below both moduli, so at the Python-int level it is the
identity (src/gadgets/utils.rs:82-101).
"""

from __future__ import annotations

import hashlib
import os
import secrets
from typing import List, Optional, Sequence

from nova_tpu_torch._device import resolve
from nova_tpu_torch.constants import NUM_HASH_BITS
from nova_tpu_torch.digest import DigestComputer, _u64, map_to_field
from nova_tpu_torch.errors import (
    InvalidInitialInputLengthError,
    InvalidStepCircuitIOError,
    InvalidStepOutputLengthError,
    NovaError,
    ProofVerifyError,
    TapeReplayError,
)
from nova_tpu_torch.frontend.constraint_system import SatisfyingAssignment, ShapeCS
from nova_tpu_torch.frontend.tape import TapeCS, trace_mode
from nova_tpu_torch.nova.circuit import (
    NovaAugmentedCircuit,
    NovaAugmentedCircuitInputs,
    StepCircuit,
    TrivialCircuit,
)
from nova_tpu_torch.nova.nifs import NIFS
from nova_tpu_torch.provider.engines import Engine
from nova_tpu_torch.provider.poseidon import PoseidonROConstants
from nova_tpu_torch.r1cs import (
    R1CSShape,
    RelaxedR1CSInstance,
    RelaxedR1CSWitness,
)


class PublicParams:
    """Public parameters for a circuit C over a cycle (E1, E2)
    (src/nova/mod.rs:40-64,125-185)."""

    def __init__(
        self,
        engine1: Engine,
        engine2: Engine,
        F_arity: int,
        r1cs_shape_primary: R1CSShape,
        ck_primary,
        r1cs_shape_secondary: R1CSShape,
        ck_secondary,
    ):
        self.engine1 = engine1
        self.engine2 = engine2
        self.F_arity = F_arity
        self.r1cs_shape_primary = r1cs_shape_primary
        self.ck_primary = ck_primary
        self.r1cs_shape_secondary = r1cs_shape_secondary
        self.ck_secondary = ck_secondary
        # ROConstants<E1> hashes E1::Base elements; circuit consts are over
        # the field the circuit is defined on (src/nova/mod.rs:131-140).
        self.ro_consts_primary = engine1.ro_constants()
        self.ro_consts_secondary = engine2.ro_constants()
        self.ro_consts_circuit_primary = PoseidonROConstants(engine2.base)
        self.ro_consts_circuit_secondary = PoseidonROConstants(engine1.base)
        self._digest: Optional[int] = None

    @staticmethod
    def setup(
        engine1: Engine,
        engine2: Engine,
        c: StepCircuit,
        ck_hint1: int = 0,
        ck_hint2: int = 0,
        device=None,
    ) -> "PublicParams":
        """src/nova/mod.rs:125-185: synthesize both augmented circuits with a
        ShapeCS, derive commitment keys sized max(cons, vars, hint) for
        `device` (CUDA unless given)."""
        device = resolve(device)
        F_arity = c.arity()
        ro_consts_circuit_primary = PoseidonROConstants(engine2.base)
        ro_consts_circuit_secondary = PoseidonROConstants(engine1.base)

        cs_primary = ShapeCS(engine1.scalar)
        NovaAugmentedCircuit(
            engine2, True, None, c, ro_consts_circuit_primary
        ).synthesize(cs_primary)
        r1cs_shape_primary = cs_primary.r1cs_shape()
        # hints may be ints or CommitmentKeyHint-style callables of the shape
        # (e.g. ppsnark's ck_floor, src/traits/snark.rs:40-50)
        h1 = ck_hint1(r1cs_shape_primary) if callable(ck_hint1) else ck_hint1
        ck_primary = r1cs_shape_primary.commitment_key(b"ck", h1, device=device)

        cs_secondary = ShapeCS(engine2.scalar)
        NovaAugmentedCircuit(
            engine1, False, None, TrivialCircuit(), ro_consts_circuit_secondary
        ).synthesize(cs_secondary)
        r1cs_shape_secondary = cs_secondary.r1cs_shape()
        h2 = ck_hint2(r1cs_shape_secondary) if callable(ck_hint2) else ck_hint2
        ck_secondary = r1cs_shape_secondary.commitment_key(b"ck", h2, device=device)

        if r1cs_shape_primary.num_io != 2 or r1cs_shape_secondary.num_io != 2:
            raise InvalidStepCircuitIOError()

        pp = PublicParams(
            engine1,
            engine2,
            F_arity,
            r1cs_shape_primary,
            ck_primary,
            r1cs_shape_secondary,
            ck_secondary,
        )
        pp.digest()
        return pp

    @staticmethod
    def setup_with_ptau_dir(
        engine1: Engine,
        engine2: Engine,
        c: StepCircuit,
        ptau_dir: str,
        ck_hint1: int = 0,
        ck_hint2: int = 0,
        device=None,
    ) -> "PublicParams":
        """Like setup(), but the primary commitment key loads from a
        Powers-of-Tau ceremony file (for HyperKZG on a pairing-friendly
        primary curve; src/nova/mod.rs:221-290), the smallest file in
        `ptau_dir` that is large enough. Both keys are for `device` (CUDA
        unless given)."""
        from nova_tpu_torch.provider.ptau import find_ptau_file, load_ck_from_ptau

        device = resolve(device)
        F_arity = c.arity()
        ro_consts_circuit_primary = PoseidonROConstants(engine2.base)
        ro_consts_circuit_secondary = PoseidonROConstants(engine1.base)

        cs_primary = ShapeCS(engine1.scalar)
        NovaAugmentedCircuit(
            engine2, True, None, c, ro_consts_circuit_primary
        ).synthesize(cs_primary)
        r1cs_shape_primary = cs_primary.r1cs_shape()
        n1 = max(r1cs_shape_primary.num_cons, r1cs_shape_primary.num_vars, ck_hint1)
        path = find_ptau_file(ptau_dir, n1)
        if path is None:
            raise NovaError(f"no ptau file in {ptau_dir} large enough for {n1}")
        ck_primary = load_ck_from_ptau(path, n1, device=device)

        cs_secondary = ShapeCS(engine2.scalar)
        NovaAugmentedCircuit(
            engine1, False, None, TrivialCircuit(), ro_consts_circuit_secondary
        ).synthesize(cs_secondary)
        r1cs_shape_secondary = cs_secondary.r1cs_shape()
        ck_secondary = r1cs_shape_secondary.commitment_key(b"ck", ck_hint2, device=device)

        if r1cs_shape_primary.num_io != 2 or r1cs_shape_secondary.num_io != 2:
            raise InvalidStepCircuitIOError()

        pp = PublicParams(
            engine1, engine2, F_arity,
            r1cs_shape_primary, ck_primary,
            r1cs_shape_secondary, ck_secondary,
        )
        pp.digest()
        return pp

    def digest(self) -> int:
        """SHA3 over a canonical serialization, 250 LE bits → E1::Scalar
        (src/nova/mod.rs:292-299, src/digest.rs:75-88)."""
        if self._digest is None:
            h = hashlib.sha3_256()
            h.update(b"nova_tpu.PublicParams")  # the protocol's domain tag, shared with nova_tpu
            h.update(self.engine1.name.encode())
            h.update(self.engine2.name.encode())
            h.update(_u64(self.F_arity))
            for shape in (self.r1cs_shape_primary, self.r1cs_shape_secondary):
                h.update(_u64(shape.num_cons))
                h.update(_u64(shape.num_vars))
                h.update(_u64(shape.num_io))
                for M in (shape.A, shape.B, shape.C):
                    h.update(DigestComputer.digest_bytes_sparse(M))
            for ck in (self.ck_primary, self.ck_secondary):
                h.update(_u64(len(ck.ck)))
                h.update(ck.h.to_transcript_bytes())
            self._digest = map_to_field(h.digest(), self.engine1.scalar)
        return self._digest

    def num_constraints(self):
        return (self.r1cs_shape_primary.num_cons, self.r1cs_shape_secondary.num_cons)

    def num_variables(self):
        return (self.r1cs_shape_primary.num_vars, self.r1cs_shape_secondary.num_vars)


class _CompiledAugmented:
    """A NovaAugmentedCircuit compiled to a replayable witness tape
    (SURVEY.md §7 hard-part 5; generalizes the reference's
    src/frontend/gadgets/poseidon/circuit2_witness.rs approach to the whole
    augmented circuit). The first synthesis records the tape; every later
    step replays pure value closures — no constraint-system bookkeeping."""

    def __init__(self, engine_circ, is_primary, step_circuit, ro_consts, field, inputs):
        self.circuit = NovaAugmentedCircuit(
            engine_circ, is_primary, inputs, step_circuit, ro_consts
        )
        self.cs = TapeCS(field)
        with trace_mode():
            self.z_out = self.circuit.synthesize(self.cs)

    def run(self, inputs, step_circuit=None):
        """Replay the tape with fresh inputs; returns (cs, z_next values).

        `step_circuit` carries this step's state (nondeterministic advice);
        its attributes are copied onto the traced circuit object so value
        closures reading `self.<attr>` observe the new step's data."""
        if step_circuit is not None and step_circuit is not self.circuit.step_circuit:
            self.circuit.step_circuit.__dict__.update(step_circuit.__dict__)
        self.circuit.inputs = inputs
        self.cs.replay()
        return self.cs, [n.get_value() for n in self.z_out]

    def z_values(self):
        return [n.get_value() for n in self.z_out]


def _tape_validate_now(step_i: int) -> bool:
    """Post-replay witness-validation cadence. NOVA_TAPE_VALIDATE=1 (or
    "always") checks every step, =0 disables; default checks the FIRST
    replayed step (i == 2, where a tape-discipline violation most often
    first diverges) and every 16th step after it — ~0.5% overhead of a
    fold step for standing insurance."""
    mode = os.environ.get("NOVA_TAPE_VALIDATE", "")
    if mode == "":
        return step_i >= 2 and (step_i - 2) % 16 == 0
    if mode in ("0", "never", "off", "false"):
        return False
    # any other non-empty value ("1", "always", "true", "yes", ...) means
    # the user asked for validation: check every step rather than
    # silently downgrading a typo to the sampled cadence
    return True


def _validate_replayed_witness(shape, U, W, which: str, device=None) -> None:
    """SpMV residual check (Az o Bz == Cz) on a tape-generated witness, in
    the native binding below DEVICE_THRESHOLD: a circuit whose Python control
    flow depends on step values replays a stale trace and silently emits an
    invalid witness — caught here with a diagnostic naming the tape
    discipline instead of a cryptic failure at verify time. Skips the
    commitment re-check (already paid by the caller)."""
    p = shape.field.p
    if shape._host_native():
        bad = shape._sat_limbs(W.W, 1, U.X)
    else:
        z = list(W.W) + [1] + list(U.X)
        Az, Bz, Cz = shape.multiply_vec(z, device)
        bad = any(
            a * b % p != c_ for a, b, c_ in zip(Az, Bz, Cz)
        )
    if bad:
        raise TapeReplayError(
            f"replayed {which} witness violates its R1CS: the step "
            "circuit broke the tape discipline (values must come from "
            "closures over self.<state>; control flow and allocation "
            "structure must not depend on step values). Set "
            "tape_safe = False on the step circuit or fix synthesize(); "
            "see StepCircuit (nova/circuit.py)."
        )


class RecursiveSNARK:
    """IVC state (src/nova/mod.rs:319-353)."""

    def __init__(
        self,
        z0,
        r_W_primary,
        r_U_primary,
        ri_primary,
        r_W_secondary,
        r_U_secondary,
        ri_secondary,
        l_w_secondary,
        l_u_secondary,
        i,
        zi,
    ):
        self.z0 = list(z0)
        self.r_W_primary = r_W_primary
        self.r_U_primary = r_U_primary
        self.ri_primary = ri_primary
        self.r_W_secondary = r_W_secondary
        self.r_U_secondary = r_U_secondary
        self.ri_secondary = ri_secondary
        self.l_w_secondary = l_w_secondary
        self.l_u_secondary = l_u_secondary
        self.i = i
        self.zi = list(zi)
        # compiled witness tapes, built lazily on the first prove_step
        self._wgen_primary = None
        self._wgen_secondary = None

    # -- base case (src/nova/mod.rs:354-453) --------------------------------
    @staticmethod
    def new(pp: PublicParams, c: StepCircuit, z0: Sequence[int]) -> "RecursiveSNARK":
        if len(z0) != pp.F_arity:
            raise InvalidInitialInputLengthError()

        e1, e2 = pp.engine1, pp.engine2
        ri_primary = secrets.randbelow(e1.scalar.p)
        ri_secondary = secrets.randbelow(e2.scalar.p)

        # base case for the primary
        cs_primary = SatisfyingAssignment(e1.scalar)
        inputs_primary = NovaAugmentedCircuitInputs(
            pp_digest=pp.digest(),
            i=0,
            z0=list(z0),
            zi=None,
            U=None,
            ri=None,
            r_next=ri_primary,
            u=None,
            T=None,
        )
        zi_primary_nums = NovaAugmentedCircuit(
            e2, True, inputs_primary, c, pp.ro_consts_circuit_primary
        ).synthesize(cs_primary)
        u_primary, w_primary = cs_primary.r1cs_instance_and_witness(
            pp.r1cs_shape_primary, pp.ck_primary
        )

        # base case for the secondary
        cs_secondary = SatisfyingAssignment(e2.scalar)
        inputs_secondary = NovaAugmentedCircuitInputs(
            pp_digest=pp.digest(),
            i=0,
            z0=[0],
            zi=None,
            U=None,
            ri=None,
            r_next=ri_secondary,
            u=u_primary,
            T=None,
        )
        NovaAugmentedCircuit(
            e1, False, inputs_secondary, TrivialCircuit(), pp.ro_consts_circuit_secondary
        ).synthesize(cs_secondary)
        u_secondary, w_secondary = cs_secondary.r1cs_instance_and_witness(
            pp.r1cs_shape_secondary, pp.ck_secondary
        )

        r_W_primary = RelaxedR1CSWitness.from_r1cs_witness(pp.r1cs_shape_primary, w_primary)
        r_U_primary = RelaxedR1CSInstance.from_r1cs_instance(
            e1.curve, pp.r1cs_shape_primary, u_primary
        )
        r_W_secondary = RelaxedR1CSWitness.default(pp.r1cs_shape_secondary)
        r_U_secondary = RelaxedR1CSInstance.default(e2.curve, pp.r1cs_shape_secondary)

        if len(zi_primary_nums) != pp.F_arity:
            raise InvalidStepOutputLengthError()
        zi = [n.get_value() for n in zi_primary_nums]

        return RecursiveSNARK(
            z0=z0,
            r_W_primary=r_W_primary,
            r_U_primary=r_U_primary,
            ri_primary=ri_primary,
            r_W_secondary=r_W_secondary,
            r_U_secondary=r_U_secondary,
            ri_secondary=ri_secondary,
            l_w_secondary=w_secondary,
            l_u_secondary=u_secondary,
            i=0,
            zi=zi,
        )

    # -- the IVC inner loop (src/nova/mod.rs:456-564) ------------------------
    def prove_step(self, pp: PublicParams, c: StepCircuit) -> None:
        if self.i == 0:
            self.i = 1
            return

        e1, e2 = pp.engine1, pp.engine2

        from nova_tpu_torch import profiling

        # fold the secondary circuit's instance
        with profiling.phase("nifs_secondary"):
            nifs_secondary, (r_U_secondary, r_W_secondary) = NIFS.prove(
                pp.ck_secondary,
                e2,
                pp.digest(),
                pp.r1cs_shape_secondary,
                self.r_U_secondary,
                self.r_W_secondary,
                self.l_u_secondary,
                self.l_w_secondary,
            )

        r_next_primary = secrets.randbelow(e1.scalar.p)

        inputs_primary = NovaAugmentedCircuitInputs(
            pp_digest=pp.digest(),
            i=self.i,
            z0=list(self.z0),
            zi=list(self.zi),
            U=self.r_U_secondary,
            ri=self.ri_primary,
            r_next=r_next_primary,
            u=self.l_u_secondary,
            T=nifs_secondary.comm_T,
        )
        replayed_primary = False
        with profiling.phase("synthesize_primary"):
            if not getattr(c, "tape_safe", True):
                cs_primary = SatisfyingAssignment(e1.scalar)
                zi_nums = NovaAugmentedCircuit(
                    e2, True, inputs_primary, c, pp.ro_consts_circuit_primary
                ).synthesize(cs_primary)
                zi_primary_vals = [n.get_value() for n in zi_nums]
            elif self._wgen_primary is None:
                self._wgen_primary = _CompiledAugmented(
                    e2, True, c, pp.ro_consts_circuit_primary, e1.scalar, inputs_primary
                )
                cs_primary = self._wgen_primary.cs
                zi_primary_vals = self._wgen_primary.z_values()
            else:
                cs_primary, zi_primary_vals = self._wgen_primary.run(inputs_primary, c)
                replayed_primary = True
        with profiling.phase("commit_primary"):
            l_u_primary, l_w_primary = cs_primary.r1cs_instance_and_witness(
                pp.r1cs_shape_primary, pp.ck_primary
            )
        if replayed_primary and _tape_validate_now(self.i):
            with profiling.phase("ivc.validate_witness"):
                _validate_replayed_witness(
                    pp.r1cs_shape_primary, l_u_primary, l_w_primary, "primary",
                    pp.ck_primary.device,
                )

        # fold the primary circuit's instance
        with profiling.phase("nifs_primary"):
            nifs_primary, (r_U_primary, r_W_primary) = NIFS.prove(
            pp.ck_primary,
            e1,
            pp.digest(),
            pp.r1cs_shape_primary,
            self.r_U_primary,
            self.r_W_primary,
            l_u_primary,
            l_w_primary,
        )

        r_next_secondary = secrets.randbelow(e2.scalar.p)

        inputs_secondary = NovaAugmentedCircuitInputs(
            pp_digest=pp.digest(),
            i=self.i,
            z0=[0],
            zi=[0],
            U=self.r_U_primary,
            ri=self.ri_secondary,
            r_next=r_next_secondary,
            u=l_u_primary,
            T=nifs_primary.comm_T,
        )
        replayed_secondary = False
        with profiling.phase("synthesize_secondary"):
            if self._wgen_secondary is None:
                self._wgen_secondary = _CompiledAugmented(
                    e1, False, TrivialCircuit(), pp.ro_consts_circuit_secondary,
                    e2.scalar, inputs_secondary,
                )
                cs_secondary = self._wgen_secondary.cs
            else:
                cs_secondary, _ = self._wgen_secondary.run(inputs_secondary)
                replayed_secondary = True
        with profiling.phase("commit_secondary"):
            l_u_secondary, l_w_secondary = cs_secondary.r1cs_instance_and_witness(
                pp.r1cs_shape_secondary, pp.ck_secondary
            )
        if replayed_secondary and _tape_validate_now(self.i):
            with profiling.phase("ivc.validate_witness"):
                _validate_replayed_witness(
                    pp.r1cs_shape_secondary, l_u_secondary, l_w_secondary,
                    "secondary", pp.ck_secondary.device,
                )

        self.zi = zi_primary_vals
        self.l_u_secondary = l_u_secondary
        self.l_w_secondary = l_w_secondary
        self.r_U_primary = r_U_primary
        self.r_W_primary = r_W_primary
        self.i += 1
        self.r_U_secondary = r_U_secondary
        self.r_W_secondary = r_W_secondary
        self.ri_primary = r_next_primary
        self.ri_secondary = r_next_secondary

    # -- verification (src/nova/mod.rs:567-665) ------------------------------
    def verify(self, pp: PublicParams, num_steps: int, z0: Sequence[int]) -> List[int]:
        if (
            num_steps == 0
            or self.i != num_steps
            or list(self.z0) != list(z0)
            or len(self.l_u_secondary.X) != 2
            or len(self.r_U_primary.X) != 2
            or len(self.r_U_secondary.X) != 2
        ):
            raise ProofVerifyError("Invalid number of steps or inputs")

        e1, e2 = pp.engine1, pp.engine2

        # hash_primary: E2's RO (over E2::Base = E1::Scalar)
        hasher = e2.new_ro()
        hasher.absorb(pp.digest())
        hasher.absorb(num_steps)
        for e in z0:
            hasher.absorb(e)
        for e in self.zi:
            hasher.absorb(e)
        self.r_U_secondary.absorb_in_ro(hasher)
        hasher.absorb(self.ri_primary)
        hash_primary = hasher.squeeze(NUM_HASH_BITS, False)

        # hash_secondary: E1's RO (over E1::Base = E2::Scalar)
        hasher2 = e1.new_ro()
        hasher2.absorb(pp.digest())
        hasher2.absorb(num_steps)
        hasher2.absorb(0)
        hasher2.absorb(0)
        self.r_U_primary.absorb_in_ro(hasher2)
        hasher2.absorb(self.ri_secondary)
        hash_secondary = hasher2.squeeze(NUM_HASH_BITS, False)

        if (
            hash_primary != self.l_u_secondary.X[0]
            or hash_secondary != self.l_u_secondary.X[1]
        ):
            raise ProofVerifyError("Invalid output hash in R1CS instances")

        pp.r1cs_shape_primary.is_sat_relaxed(pp.ck_primary, self.r_U_primary, self.r_W_primary)
        pp.r1cs_shape_secondary.is_sat_relaxed(
            pp.ck_secondary, self.r_U_secondary, self.r_W_secondary
        )
        pp.r1cs_shape_secondary.is_sat(pp.ck_secondary, self.l_u_secondary, self.l_w_secondary)

        return list(self.zi)

    def outputs(self) -> List[int]:
        return list(self.zi)

    def num_steps(self) -> int:
        return self.i
