"""Run one cell of the benchmark of the PyTorch/CUDA prover.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up (imports, keys, the window's shapes
warmed) counts as setup_s; then the cell's kind of traffic runs its window for
--seconds; then the outputs are compared with the plain reference. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device and, with --trace 1, breakdown, then checks (each number
compared, beside its limit). Exits 2 without a usable card, 3 if the JAX
package or JAX was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "nova_tpu")
LIMIT = 0  # every number compared is a count of disagreements


def _caches() -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    cache = os.path.join(BENCH_DIR, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, fault=None) -> dict:
    """Set up, run the window and compare; returns the result line's object.
    `device` is a torch.device (the CPU in tests, which skip the card
    check); `fault`, one of benchlib.faults, is planted for the window."""
    from benchlib.spec import load_kind
    from benchlib.trace import Tracer

    if trace:
        os.environ["NOVA_PROFILE"] = "1"  # the prover's own phase totals
    tracer = Tracer(trace)
    out = load_kind(cell)(cell, seed, seconds, tracer, device, fault)
    t_ref = time.perf_counter()
    checks = out.check()
    print(f"portbench: setup {out.window_start - T_START:.3f} s, window {out.window_s:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s; {json.dumps(out.info)}", file=sys.stderr)
    if trace:
        ctx = dict(out.ctx, window_s=out.window_s)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m.name](ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        vals = dict(out.end_to_end, setup_s=out.window_start - T_START)
        metrics = {m.name: {"value": vals[m.name], "unit": m.unit} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    res = {"correct": all(v <= LIMIT for v in checks.values()),
           "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": dev}
    if trace and out.ctx.get("trace"):
        t = out.ctx["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        res["breakdown"] = t["breakdown"]
    res["checks"] = {k: {"value": v, "limit": LIMIT} for k, v in checks.items()}
    return res


def _device_name(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [ROOT, BENCH_DIR]
    from benchlib.spec import cell as load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
