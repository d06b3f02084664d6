"""Kind "ivc_fold": RecursiveSNARK.prove_step back to back, one caller, on
the step circuit that the traffic names (``circuits/<circuit>.py``, built
from ``circuit_args``). Set-up makes the public parameters, the first
`warm_steps` calls (the first step, the tape build, a replay) and so every
shape the window uses; the window holds replayed steps only. After it the
reference judges the IVC state: the output against the step function, the
running instances row by row, the step circuit's rows in the primary shape,
and the commitments against fresh MSMs."""

import hashlib
import os
import time

from benchlib.kit import Outcome, csr, failed, free, ints, peak, point, sync, window
from benchlib.spec import Cell, load_file


def _ptau_dir(cell: Cell, power: int, e1) -> tuple:
    """The test ptau file of the configuration's tau, written once into the
    benchmark's cache directory; returns (directory, tau)."""
    from nova_tpu_torch.provider import ptau

    key = cell.config["primary_key"]
    tau = int.from_bytes(hashlib.sha256(key["tau_label"].encode()).digest(), "little") % e1.scalar.p
    d = os.path.join(cell.bench_dir, "_cache", "ptau", key["tau_label"])
    path = os.path.join(d, f"ppot_pruned_{power:02d}.ptau")
    if not os.path.exists(path):
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        ptau.write_test_ptau(tmp, tau, power)
        os.replace(tmp, path)
    return d, tau


def run(cell: Cell, seed: int, seconds: float, tracer, dev, fault=None) -> Outcome:
    import torch

    from nova_tpu_torch.frontend.constraint_system import ShapeCS
    from nova_tpu_torch.nova.circuit import NovaAugmentedCircuit, TrivialCircuit
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider import engines
    from nova_tpu_torch.provider.poseidon import PoseidonROConstants

    cfg, tr = cell.config, cell.traffic
    e1, e2 = (getattr(engines, n) for n in cfg["engines"])
    cs = ShapeCS(e1.scalar)
    NovaAugmentedCircuit(e2, True, None, TrivialCircuit(),
                         PoseidonROConstants(e2.base)).synthesize(cs)
    step = load_file("circuits", tr["circuit"], cell.bench_dir)
    args = tr.get("circuit_args", {})
    circuit, params, rows = step.build(args, cs.r1cs_shape().num_cons)
    keys = {"primary": dict(cfg["primary_key"]), "secondary": dict(cfg["secondary_key"])}
    if keys["primary"]["kind"] == "ptau":
        d, tau = _ptau_dir(cell, max(1, (rows - 1).bit_length()), e1)
        keys["primary"] = {"kind": "ptau", "tau": tau}
        pp = PublicParams.setup_with_ptau_dir(e1, e2, circuit, d, device=dev)
    else:
        pp = PublicParams.setup(e1, e2, circuit, device=dev)
    if pp.num_constraints()[0] != rows:
        raise RuntimeError(f"primary has {pp.num_constraints()[0]} constraints, {rows} stated")
    z0 = step.z0(args, seed, e1.scalar.p)
    rs = RecursiveSNARK.new(pp, circuit, z0)
    calls = 0
    for _ in range(tr["warm_steps"]):
        rs.prove_step(pp, circuit)
        calls += 1
    sync(torch, dev)
    steps, error = 0, None
    with window(tracer, fault):
        if tracer.enabled:
            from nova_tpu_torch import profiling

            profiling.global_reset()
        t0 = time.perf_counter()
        while True:
            try:
                with tracer.span("portbench:prove_step"):
                    rs.prove_step(pp, circuit)
                    sync(torch, dev)
            except Exception as e:  # a failed call ends the window
                error = e
                break
            steps += 1
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    mem = peak(torch, dev)
    phases = {}
    if tracer.enabled:
        from nova_tpu_torch import profiling

        phases = dict(profiling._GLOBAL.totals)

    def side(shape, U, W, curve, key):
        return {"curve": curve, "key": key, "p": shape.field.p,
                "shape": {k: csr(getattr(shape, k)) for k in "ABC"},
                "U": {"comm_W": point(U.comm_W), "comm_E": point(U.comm_E),
                      "X": [int(x) for x in U.X], "u": int(U.u)},
                "W": {"W": ints(W.W), "r_W": int(W.r_W), "E": ints(W.E), "r_E": int(W.r_E)}}

    state = {
        "circuit": tr["circuit"], "params": params, "z0": z0, "calls": calls,
        "zi": [int(x) for x in rs.zi],
        "primary": side(pp.r1cs_shape_primary, rs.r_U_primary, rs.r_W_primary,
                        pp.ck_primary.curve.name, keys["primary"]),
        "secondary": side(pp.r1cs_shape_secondary, rs.r_U_secondary, rs.r_W_secondary,
                          pp.ck_secondary.curve.name, keys["secondary"]),
    }
    state["secondary"]["last"] = {
        "U": {"comm_W": point(rs.l_u_secondary.comm_W), "X": [int(x) for x in rs.l_u_secondary.X]},
        "W": {"W": ints(rs.l_w_secondary.W), "r_W": int(rs.l_w_secondary.r_W)},
    }
    info = dict(params, constraints=list(pp.num_constraints()), steps=steps, calls=calls)
    del rs, pp
    free(torch, dev)

    from pbref.checks import fold_checks

    return Outcome(
        window_start=t0, window_s=t1 - t0, attempted=steps + (error is not None),
        failed=int(error is not None),
        end_to_end={"step_s": (t1 - t0) / max(steps, 1)},
        ctx={"steps": steps, "phases_s": phases, "trace": tracer.result},
        memory_peak_bytes=mem,
        check=failed(error) if error else lambda: fold_checks(state, seed), info=info)
