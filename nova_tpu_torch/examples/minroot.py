"""MinRoot VDF IVC example (the twin of ``examples/minroot.py``; reference
examples/minroot.rs).

Each step verifies `iters_per_step` MinRoot iterations
  x_{i+1} = (x_i + y_i)^{1/5},  y_{i+1} = x_i
using non-deterministic advice: the fifth root is allocated as advice and
the circuit checks x_{i+1}^5 = x_i + y_i with 3 constraints per iteration
(two squares and one product).

    python -m nova_tpu_torch.examples.minroot [iters_per_step] [num_steps]

The defaults are 128 and 3. At 2^15 iterations a step the primary
augmented circuit has 98,304 + 9,818 constraints and pads to 2^17.
"""

from __future__ import annotations

import sys
import time

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.frontend.constraint_system import lc
from nova_tpu_torch.frontend.num import AllocatedNum
from nova_tpu_torch.nova.circuit import StepCircuit


class MinRootIteration:
    def __init__(self, x_i, y_i, x_next, y_next):
        self.x_i, self.y_i = x_i, y_i
        self.x_i_plus_1, self.y_i_plus_1 = x_next, y_next

    @staticmethod
    def seq(field, num_iters, x0, y0):
        """([x0, y0], the advice of `num_iters` iterations), each fifth
        root checked (the exponent is the reference's)."""
        p = field.p
        exp = (pow(5, p - 2, p) * (p - 3)) % p
        out = []
        x_i, y_i = x0, y0
        for _ in range(num_iters):
            x_next = pow((x_i + y_i) % p, exp, p)
            if pow(x_next, 5, p) != (x_i + y_i) % p:
                raise ArithmeticError("MinRoot: the fifth root does not check")
            out.append(MinRootIteration(x_i, y_i, x_next, x_i))
            x_i, y_i = x_next, x_i
        return [x0, y0], out


class MinRootCircuit(StepCircuit):
    def __init__(self, seq):
        self.seq = seq

    def arity(self):
        return 2

    def synthesize(self, cs, z):
        if not self.seq:
            return list(z)
        x_i, y_i = z[0], z[1]
        for k in range(len(self.seq)):
            x_next = AllocatedNum.alloc(cs, lambda k=k: self.seq[k].x_i_plus_1)
            sq = x_next.square(cs)
            quad = sq.square(cs)
            # quad * x_next = x_i + y_i
            cs.enforce(
                lc((1, quad.get_variable())),
                lc((1, x_next.get_variable())),
                lc((1, x_i.get_variable()), (1, y_i.get_variable())),
            )
            x_i, y_i = x_next, x_i
        return [x_i, y_i]


def main(argv=None, device=None) -> dict:
    """Prove `num_steps` steps of `iters_per_step` iterations on `device`
    (the card unless "cpu"), verify, compress and verify the compressed
    proof. Returns the run's objects and wall seconds: pp, circuits, z0,
    rs, zn, pk, vk, proof, seconds."""
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    argv = sys.argv[1:] if argv is None else argv
    iters_per_step = int(argv[0]) if len(argv) > 0 else 128
    num_steps = int(argv[1]) if len(argv) > 1 else 3
    dev = entry_device(device)
    e1, e2 = PallasEngine, VestaEngine
    seconds = {}

    print(f"MinRoot IVC: {iters_per_step} iters/step x {num_steps} steps on {dev}")

    # produce all advice up front (examples/minroot.rs:142-180)
    t = time.time()
    z0, all_iters = MinRootIteration.seq(e1.scalar, iters_per_step * num_steps, 2, 3)
    circuits = [
        MinRootCircuit(all_iters[i * iters_per_step : (i + 1) * iters_per_step])
        for i in range(num_steps)
    ]
    seconds["advice"] = time.time() - t

    t = time.time()
    pp = PublicParams.setup(e1, e2, circuits[0], device=dev)
    seconds["setup"] = time.time() - t
    print(f"PublicParams::setup  {seconds['setup']:.2f}s  "
          f"constraints {pp.num_constraints()}")

    t = time.time()
    rs = RecursiveSNARK.new(pp, circuits[0], z0)
    seconds["new"] = time.time() - t
    print(f"RecursiveSNARK::new  {seconds['new']:.2f}s")

    seconds["prove_step"] = []
    for i, c in enumerate(circuits):
        t = time.time()
        rs.prove_step(pp, c)
        seconds["prove_step"].append(time.time() - t)
        print(f"prove_step {i}  {seconds['prove_step'][-1]:.2f}s")

    t = time.time()
    zn = rs.verify(pp, num_steps, z0)
    seconds["verify"] = time.time() - t
    print(f"RecursiveSNARK::verify  {seconds['verify']:.2f}s  z_n={zn}")

    t = time.time()
    pk, vk = CompressedSNARK.setup(pp)
    seconds["compressed_setup"] = time.time() - t
    print(f"CompressedSNARK::setup  {seconds['compressed_setup']:.2f}s")
    t = time.time()
    proof = CompressedSNARK.prove(pp, pk, rs)
    seconds["compressed_prove"] = time.time() - t
    print(f"CompressedSNARK::prove  {seconds['compressed_prove']:.2f}s")
    t = time.time()
    proof.verify(vk, num_steps, z0)
    seconds["compressed_verify"] = time.time() - t
    print(f"CompressedSNARK::verify  {seconds['compressed_verify']:.2f}s")
    print("OK")
    return {"pp": pp, "circuits": circuits, "z0": z0, "rs": rs, "zn": zn, "pk": pk,
            "vk": vk, "proof": proof, "seconds": seconds}


if __name__ == "__main__":
    main()
