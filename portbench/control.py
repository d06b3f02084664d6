"""Runs of one cell on several seeds in one process, with the control
planted (the program's commitments of the scalars' low 128 bits,
benchlib.faults.truncated) or without it: the readings that the limits of
`correct` are set from. Not part of the benchmark's own runs.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 5 [--control]

Prints one JSON line a seed: whether the control ran, the seed, correct,
and each number compared."""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    import run
    from benchlib.faults import truncated
    from benchlib.spec import cell as load_cell

    run._caches()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                           truncated if args.control else None)
        print(json.dumps({"control": args.control, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
