"""CompressedSNARK prove/verify grid (the twin of
``benches/compressed_snark.py``; reference benches/compressed-snark.rs:43-58):
the recursive-snark size grid x {snark (S1/S2), ppsnark (SS1/SS2)}, on the
card.

    python -m nova_tpu_torch.benches.compressed_snark [--sizes 0] [--quick]

A size is the log2 of the extra step-circuit constraints (0: the minimal
TrivialCircuit augmented pair); --quick runs the snark configuration
only."""

from __future__ import annotations

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, timeit


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed, each with the verified output z_n added."""
    from nova_tpu_torch.nova.circuit import NonTrivialCircuit, TrivialCircuit
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine
    from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as PP

    sizes, args = parse_args([0], argv)
    dev = entry_device(device)
    configs = [("snark", None, None, {})]
    if not args.quick:
        configs.append(
            ("ppsnark", PP, PP, {"ck_hint1": PP.ck_floor, "ck_hint2": PP.ck_floor})
        )
    rows = []
    for lg in sizes:
        c = TrivialCircuit() if lg == 0 else NonTrivialCircuit(1 << lg)
        z0 = [0] if lg == 0 else [2]
        for name, S1, S2, hints in configs:
            pp = PublicParams.setup(PallasEngine, VestaEngine, c, device=dev, **hints)
            rs = RecursiveSNARK.new(pp, c, z0)
            rs.prove_step(pp, c)
            rs.prove_step(pp, c)
            pk, vk = CompressedSNARK.setup(pp, S1=S1, S2=S2)
            t = timeit(lambda: CompressedSNARK.prove(pp, pk, rs))
            proof = CompressedSNARK.prove(pp, pk, rs)
            zn = []
            tv = timeit(lambda: zn.append(proof.verify(vk, rs.i, z0)))
            row = emit("compressed-snark", f"{name} cons={pp.num_constraints()}", t,
                       {"prove_s": round(t, 2), "verify_s": round(tv, 2)})
            rows.append({**row, "zn": zn[-1]})
    return rows


if __name__ == "__main__":
    main()
