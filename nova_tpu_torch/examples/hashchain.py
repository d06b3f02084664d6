"""Poseidon hash-chain IVC example (the twin of ``examples/hashchain.py``;
reference examples/hashchain.rs).

Each step absorbs the running digest plus num_elts_per_step fresh field
elements into a width-24 Poseidon sponge and squeezes the next digest; the
verified output must equal the chain recomputed natively.

    python -m nova_tpu_torch.examples.hashchain [num_elts_per_step] [num_steps]

The defaults are 64 and 2; the elements come from random.Random(0xC4A1),
as in the JAX script, unless the caller of ``main`` passes another seed.
"""

from __future__ import annotations

import random
import sys
import time

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.gadgets.poseidon_circuit import Elt, sponge_hash_circuit
from nova_tpu_torch.nova.circuit import StepCircuit
from nova_tpu_torch.provider.poseidon import api_constants, sponge_hash

SEED = 0xC4A1


class HashChainCircuit(StepCircuit):
    def __init__(self, field, x_i):
        self.field = field
        self.x_i = x_i
        self._consts = api_constants(field, 24)

    @staticmethod
    def random(field, num_elts, rng: random.Random):
        return HashChainCircuit(field, [rng.randrange(field.p) for _ in range(num_elts)])

    def arity(self):
        return 1

    def synthesize(self, cs, z_in):
        assert len(z_in) == 1
        xs = [
            AllocatedNum.alloc(cs, lambda i=i: self.x_i[i])
            for i in range(len(self.x_i))
        ]
        elts = [Elt.from_allocated(e) for e in list(z_in) + xs]
        z_out = sponge_hash_circuit(cs, self._consts, elts)
        return [z_out]

    def native_digest(self, acc):
        return sponge_hash(self._consts, [acc] + list(self.x_i))


def main(argv=None, device=None, seed=SEED) -> dict:
    """Prove and verify on `device` (the card unless "cpu"), the elements
    drawn from random.Random(seed); raises if the verified digest differs
    from the native recomputation. Returns pp, rs, zn."""
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    argv = sys.argv[1:] if argv is None else argv
    num_elts = int(argv[0]) if len(argv) > 0 else 64
    num_steps = int(argv[1]) if len(argv) > 1 else 2
    dev = entry_device(device)
    rng = random.Random(seed)
    e1, e2 = PallasEngine, VestaEngine
    f = e1.scalar

    print(f"HashChain IVC: {num_elts} elts/step x {num_steps} steps on {dev}")
    circuits = [HashChainCircuit.random(f, num_elts, rng) for _ in range(num_steps)]

    t = time.time()
    pp = PublicParams.setup(e1, e2, circuits[0], device=dev)
    print(f"setup {time.time()-t:.2f}s constraints {pp.num_constraints()}")

    t = time.time()
    rs = RecursiveSNARK.new(pp, circuits[0], [0])
    for c in circuits:
        rs.prove_step(pp, c)
    print(f"prove {time.time()-t:.2f}s")

    zn = rs.verify(pp, num_steps, [0])

    # recompute the chain natively
    acc = 0
    for c in circuits:
        acc = c.native_digest(acc)
    if zn != [acc]:
        raise AssertionError(f"digest mismatch: {zn} != [{acc}]")
    print("digest matches native recomputation; OK")
    return {"pp": pp, "rs": rs, "zn": zn}


if __name__ == "__main__":
    main()
