"""RecursiveSNARK prove_step/verify grid (the twin of
``benches/recursive_snark.py``; reference benches/recursive-snark.rs:37-53):
augmented-circuit sizes from the base ~10k constraints up, by padding the
step circuit with a squaring chain, on the card.

    python -m nova_tpu_torch.benches.recursive_snark [--sizes 0,13,14]

A size is the log2 of the extra constraints (0: one square)."""

from __future__ import annotations

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, timeit
from nova_tpu_torch.nova.circuit import NonTrivialCircuit


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed, each with the public parameters' digest added."""
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    sizes, _ = parse_args([0, 13, 14], argv)
    dev = entry_device(device)
    rows = []
    for lg in sizes:
        extra = 0 if lg == 0 else 1 << lg
        c = NonTrivialCircuit(max(extra, 1))
        pp = PublicParams.setup(PallasEngine, VestaEngine, c, device=dev)
        num_cons = pp.num_constraints()
        rs = RecursiveSNARK.new(pp, c, [2])
        rs.prove_step(pp, c)
        rs.prove_step(pp, c)  # warm
        dt = timeit(lambda: rs.prove_step(pp, c))
        dv = timeit(lambda: rs.verify(pp, rs.i, [2]))
        row = emit("recursive-snark", f"cons={num_cons}", dt,
                   {"prove_step_ms": round(dt * 1e3, 1),
                    "verify_ms": round(dv * 1e3, 1)})
        rows.append({**row, "pp_digest": pp.digest()})
    return rows


if __name__ == "__main__":
    main()
