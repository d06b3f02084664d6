"""DirectSNARK/ppsnark grid (the twin of ``benches/ppsnark.py``; reference
benches/ppsnark.rs): the NonTrivial step circuit's sizes, a direct spark
proof without IVC, on the card.

    python -m nova_tpu_torch.benches.ppsnark [--sizes 10,12]"""

from __future__ import annotations

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, timeit


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed, each with the shape's constraint count added."""
    from nova_tpu_torch.nova.circuit import NonTrivialCircuit
    from nova_tpu_torch.provider.engines import PallasEngine
    from nova_tpu_torch.spartan.direct import DirectSNARK
    from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as PP

    sizes, _ = parse_args([10, 12], argv)
    dev = entry_device(device)
    rows = []
    for lg in sizes:
        c = NonTrivialCircuit(1 << lg)
        pk, vk = DirectSNARK.setup(PallasEngine, c, S_snark=PP, device=dev)
        t = timeit(lambda: DirectSNARK.prove(PallasEngine, pk, c, [2], S_snark=PP))
        row = emit("ppsnark-direct", f"2^{lg} cons", t, {"prove_s": round(t, 2)})
        rows.append({**row, "num_cons": pk.S.num_cons})
    return rows


if __name__ == "__main__":
    main()
