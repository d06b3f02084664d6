"""Eq-sumcheck bench (the twin of ``benches/sumcheckeq.py``; reference
benches/sumcheckeq.rs:36-40, up to 2^26 variables): the Gruen/BDDT
eq-factored outer sumcheck against the materialized-eq prover
(NOVA_NO_GRUEN=1), both on the host, and the device-resident prover
(ops/sumcheck.py) on the card; all three must give one proof.

    python -m nova_tpu_torch.benches.sumcheckeq [--sizes 14,16]"""

from __future__ import annotations

import os

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, rng, timeit


def proof_values(res) -> tuple:
    """(round polynomials, r, claims) of a sumcheck prover's result, as
    ints."""
    proof, r, claims = res
    return ([list(p.coeffs_except_linear_term) for p in proof.compressed_polys],
            list(r), list(claims))


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed, each with the three provers' results (proof_values) added."""
    from nova_tpu_torch.ops.sumcheck import prove_cubic_with_three_inputs_device
    from nova_tpu_torch.provider.engines import PallasEngine
    from nova_tpu_torch.provider.keccak import Keccak256Transcript
    from nova_tpu_torch.spartan.polys import EqPolynomial, MultilinearPolynomial
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    sizes, _ = parse_args([14, 16], argv)
    dev = entry_device(device)
    f = PallasEngine.scalar
    r = rng()
    rows = []
    for lg in sizes:
        n = 1 << lg
        Az = [r.randrange(f.p) for _ in range(n)]
        Bz = [r.randrange(f.p) for _ in range(n)]
        Cz = [r.randrange(f.p) for _ in range(n)]
        taus = [r.randrange(1, f.p) for _ in range(lg)]
        eq = EqPolynomial.evals_from_points(f, taus)
        claim = sum(e * (a * b - c) for e, a, b, c in zip(eq, Az, Bz, Cz)) % f.p
        out = {}

        def run(route):
            tr = Keccak256Transcript(b"b", f)
            if route == "device":
                res = prove_cubic_with_three_inputs_device(f, claim, taus, Az, Bz, Cz, tr,
                                                           device=dev)
            else:
                res = SumcheckProof.prove_cubic_with_three_inputs(
                    f, claim, taus, MultilinearPolynomial(f, Az),
                    MultilinearPolynomial(f, Bz), MultilinearPolynomial(f, Cz), tr)
            out[route] = proof_values(res)

        dt = timeit(lambda: run("gruen"))
        os.environ["NOVA_NO_GRUEN"] = "1"
        try:
            dt_mat = timeit(lambda: run("materialized"))
        finally:
            del os.environ["NOVA_NO_GRUEN"]
        dt_dev = timeit(lambda: run("device"))
        if not out["gruen"] == out["materialized"] == out["device"]:
            raise AssertionError(f"sumcheck-eq 2^{lg}: the provers' proofs differ")
        row = emit("sumcheck-eq", f"2^{lg}", dt,
                   {"gruen_s": round(dt, 3), "materialized_s": round(dt_mat, 3),
                    "device_s": round(dt_dev, 3)})
        rows.append({**row, "proofs": out})
    return rows


if __name__ == "__main__":
    main()
