"""SHA-256 step-circuit bench (the twin of ``benches/sha256.py``;
reference benches/sha256.rs): a single step's prove over message sizes, on
the card.

    python -m nova_tpu_torch.benches.sha256 [--sizes 64,128]

A size is the message length in bytes (all-zero bits, as in the JAX
bench)."""

from __future__ import annotations

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, timeit
from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
from nova_tpu_torch.frontend.sha256 import sha256 as sha256_gadget
from nova_tpu_torch.nova.circuit import StepCircuit


class Sha256Circuit(StepCircuit):
    def __init__(self, msg_len: int):
        self.msg_len = msg_len

    def arity(self):
        return 1

    def synthesize(self, cs, z):
        bits = [
            Boolean.from_bit(AllocatedBit.alloc(cs, (lambda: False)))
            for _ in range(self.msg_len * 8)
        ]
        sha256_gadget(cs, bits)
        return [z[0]]


def public_params(msg_len: int, device=None):
    """The bench's PublicParams for an `msg_len`-byte message on `device`."""
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    return PublicParams.setup(PallasEngine, VestaEngine, Sha256Circuit(msg_len),
                              device=device)


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed."""
    from nova_tpu_torch.nova.ivc import RecursiveSNARK

    sizes, _ = parse_args([64, 128], argv)
    dev = entry_device(device)
    rows = []
    for n in sizes:
        c = Sha256Circuit(n)
        pp = public_params(n, dev)
        rs = RecursiveSNARK.new(pp, c, [0])
        rs.prove_step(pp, c)
        rs.prove_step(pp, c)
        dt = timeit(lambda: rs.prove_step(pp, c))
        rows.append(emit("sha256", f"{n}B message", dt,
                         {"constraints": pp.num_constraints()[0],
                          "prove_step_ms": round(dt * 1e3, 1)}))
    return rows


if __name__ == "__main__":
    main()
