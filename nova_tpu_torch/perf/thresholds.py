"""Time the commit and cross-term routes on both sides of the routing
thresholds (``constants.DEVICE_THRESHOLD``, ``FOLD_DEVICE_THRESHOLD``) at
n = 2^10 ... 2^17 on one GPU, on a BN254 powers-of-tau key of 2^17 rows:

- an int list: the native host MSM (``native.msm_cached``) against
  ``msm_device2``;
- an FVec on the card: bringing it to the host plus the native MSM against
  ``msm_device3_mont``;
- the cross-term of a fold and its commit: the native host route
  (``R1CSShape._commit_T_limbs``) against ``ops.fold.commit_T_device`` and
  the fixed-base device MSM, on a square chain of n squarings.

Each time is the median of 3 after a warm-up, on the host clock up to a
synchronise. The two routes of each pair are held equal (points, and T
element for element), and the script fails if they are not. It prints one
JSON object, the times by size and the first size at which each device
route is the faster, and appends it to ``--out``.

    python3 nova_tpu_torch/perf/thresholds.py [--ptau FILE] [--out FILE]

``--ptau`` is a ptau file of at least 2^17 G1 powers (2^17 are read);
the default is the power-19 one ``chip_smoke.py`` writes (tau drawn from
its seed) into ``nova_tpu_torch/_build/ptau/``, so run this after it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20269
REPS = 3
MAX_LOG = 17
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def chain_shape(field, n: int):
    """A regular R1CS of n squares (n constraints and variables, 2 public
    inputs): z[i+1] = z[i]^2 for i < n - 1, and z[n-1] * u = X[0]."""
    from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

    one, ptr, cols = [1] * n, list(range(n + 1)), n + 3
    A = SparseMatrix(field, one, list(range(n)), ptr, cols)
    B = SparseMatrix(field, one, list(range(n - 1)) + [n], ptr, cols)
    C = SparseMatrix(field, one, list(range(1, n)) + [n + 1], ptr, cols)
    return R1CSShape(field, n, n, 2, A, B, C)


def sweep(torch, ck, dev) -> dict:
    import numpy as np

    from nova_tpu_torch import native
    from nova_tpu_torch.ops import fold as fold_ops
    from nova_tpu_torch.ops import msm2, msm3
    from nova_tpu_torch.ops.fvec import FVec, HVec
    from nova_tpu_torch.provider.pedersen import Commitment
    from nova_tpu_torch.r1cs import (
        R1CSInstance,
        R1CSWitness,
        RelaxedR1CSInstance,
        RelaxedR1CSWitness,
    )

    curve, field = ck.curve, ck.curve.scalar
    p = field.p
    rng = np.random.default_rng(SEED)
    db = ck.device_bases2(len(ck.ck))
    arrays = ck.host_arrays(len(ck.ck))

    def ms(fn):
        res = fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), res

    def rand(n):
        raw = rng.bytes(32 * n)
        return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") % p for i in range(n)]

    out = {}
    comm = Commitment.default(curve)
    for k in range(10, MAX_LOG + 1):
        n = 1 << k
        scal = rand(n)
        v = FVec.from_ints(field, scal, device=dev)
        row = {}
        row["int_native_ms"], a = ms(lambda: native.msm_cached(curve, arrays, scal))
        row["int_msm_device2_ms"], b = ms(
            lambda: msm2.msm_device2(scal, device_bases=db, reuse=True))
        row["fvec_native_ms"], c = ms(
            lambda: native.msm_cached(curve, arrays, FVec(v.tf, v.m).to_ints()))
        row["fvec_msm_device3_ms"], d = ms(lambda: msm3.msm_device3_mont(v.m, db))
        if not a == b == c == d:
            raise SystemExit(f"thresholds: the MSM routes disagree at 2^{k}")
        S = chain_shape(field, n)
        X1, X2, (u1,) = rand(2), rand(2), rand(1)
        W1, E1, W2 = rand(n), rand(n), rand(n)
        U1, U2 = RelaxedR1CSInstance(comm, comm, X1, u1), R1CSInstance(comm, X2)
        # the running witness as each route holds it, the new one as ints
        Wh = RelaxedR1CSWitness(HVec(p, ints=W1), 0, HVec(p, ints=E1), 0)
        Wf = RelaxedR1CSWitness(FVec.from_ints(field, W1, device=dev), 0,
                                FVec.from_ints(field, E1, device=dev), 0)
        W2w = R1CSWitness(W2, 0)
        row["cross_term_native_ms"], (Th, ch) = ms(
            lambda: S._commit_T_limbs(ck, U1, Wh, U2, W2w, 0, (u1 + 1) % p))

        def device_T():
            T = fold_ops.commit_T_device(S, U1, Wf, U2, W2w, False, dev)
            return T, msm3.msm_device3_mont(T.m, db)

        row["cross_term_device_ms"], (Td, cd) = ms(device_T)
        if Th.to_ints() != Td.to_ints() or ch.point != cd:
            raise SystemExit(f"thresholds: the cross-term routes disagree at 2^{k}")
        out[f"2^{k}"] = row
        print(f"2^{k}: " + json.dumps(row), file=sys.stderr, flush=True)
    cross = {}
    for host, device in (("int_native_ms", "int_msm_device2_ms"),
                         ("fvec_native_ms", "fvec_msm_device3_ms"),
                         ("cross_term_native_ms", "cross_term_device_ms")):
        faster = [k for k, r in out.items() if r[device] < r[host]]
        cross[f"{device} < {host} from"] = faster[0] if faster else None
    return {"sizes": out, "crossovers": cross}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ptau", default=os.path.join(
        ROOT, "nova_tpu_torch", "_build", "ptau", "ppot_pruned_19.ptau"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from nova_tpu_torch import native
    from nova_tpu_torch.provider.ptau import load_ck_from_ptau

    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        print("thresholds: no CUDA device", file=sys.stderr)
        return 2
    if not native.available():
        print("thresholds: the native host binding did not build", file=sys.stderr)
        return 2
    if not os.path.exists(args.ptau):
        print(f"thresholds: no ptau file {args.ptau} (chip_smoke.py writes it)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    ck = load_ck_from_ptau(args.ptau, 1 << MAX_LOG, device=dev)
    res = {"card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               stdout=subprocess.PIPE, text=True).stdout.strip(),
           "key_rows": len(ck.ck), "key_load_s": time.perf_counter() - t0}
    res.update(sweep(torch, ck, dev))
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
