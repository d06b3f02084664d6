"""Bitwise-AND IVC example (the twin of ``examples/and_example.py``;
reference examples/and.rs).

Each step proves a batch of 64-bit AND operations: allocate a, b, their
little-endian bit decompositions, enforce the decompositions, AND the bits,
and enforce the recomposition.

    python -m nova_tpu_torch.examples.and_example [num_ops_per_step] [num_steps]

The defaults are 4 and 2. The operands come from random.Random(seed): an
unseeded generator unless the caller of ``main`` passes a seed.
"""

from __future__ import annotations

import random
import sys
import time

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.frontend.boolean import AllocatedBit
from nova_tpu_torch.frontend.constraint_system import ONE, lc
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.gadgets.utils import le_bits_to_num
from nova_tpu_torch.nova.circuit import StepCircuit


def u64_into_bit_vec_le(cs, value):
    vfn = value if callable(value) else (lambda: value)
    return [
        AllocatedBit.alloc(
            cs, lambda i=i: None if vfn() is None else bool((vfn() >> i) & 1)
        )
        for i in range(64)
    ]


class AndCircuit(StepCircuit):
    def __init__(self, batch):
        self.batch = batch  # list of (a, b) u64 pairs

    @staticmethod
    def random(num_ops, rng: random.Random):
        return AndCircuit([(rng.getrandbits(64), rng.getrandbits(64)) for _ in range(num_ops)])

    def arity(self):
        return 1

    def synthesize(self, cs, z_in):
        for k in range(len(self.batch)):
            a_val = lambda k=k: self.batch[k][0]  # noqa: E731
            b_val = lambda k=k: self.batch[k][1]  # noqa: E731
            a = AllocatedNum.alloc(cs, a_val)
            b = AllocatedNum.alloc(cs, b_val)
            a_bits = u64_into_bit_vec_le(cs, a_val)
            b_bits = u64_into_bit_vec_le(cs, b_val)
            a_from_bits = le_bits_to_num(cs, a_bits)
            b_from_bits = le_bits_to_num(cs, b_bits)
            cs.enforce(lc((1, a.get_variable())), lc((1, ONE)),
                       lc((1, a_from_bits.get_variable())))
            cs.enforce(lc((1, b.get_variable())), lc((1, ONE)),
                       lc((1, b_from_bits.get_variable())))
            c_bits = [
                AllocatedBit.and_(cs, x, y) for x, y in zip(a_bits, b_bits)
            ]
            c_from_bits = le_bits_to_num(cs, c_bits)
            c = AllocatedNum.alloc(cs, lambda k=k: self.batch[k][0] & self.batch[k][1])
            cs.enforce(lc((1, c.get_variable())), lc((1, ONE)),
                       lc((1, c_from_bits.get_variable())))
        return list(z_in)


def main(argv=None, device=None, seed=None) -> dict:
    """Prove and verify on `device` (the card unless "cpu"), the operands
    drawn from random.Random(seed). Returns pp, rs, zn."""
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    argv = sys.argv[1:] if argv is None else argv
    num_ops = int(argv[0]) if len(argv) > 0 else 4
    num_steps = int(argv[1]) if len(argv) > 1 else 2
    dev = entry_device(device)
    rng = random.Random(seed)
    e1, e2 = PallasEngine, VestaEngine

    print(f"AND IVC: {num_ops} ops/step x {num_steps} steps on {dev}")
    circuits = [AndCircuit.random(num_ops, rng) for _ in range(num_steps)]

    t = time.time()
    pp = PublicParams.setup(e1, e2, circuits[0], device=dev)
    print(f"setup {time.time()-t:.2f}s constraints {pp.num_constraints()}")

    t = time.time()
    rs = RecursiveSNARK.new(pp, circuits[0], [0])
    for c in circuits:
        rs.prove_step(pp, c)
    print(f"prove {time.time()-t:.2f}s")

    t = time.time()
    zn = rs.verify(pp, num_steps, [0])
    print(f"verify {time.time()-t:.2f}s")
    print("OK")
    return {"pp": pp, "rs": rs, "zn": zn}


if __name__ == "__main__":
    main()
