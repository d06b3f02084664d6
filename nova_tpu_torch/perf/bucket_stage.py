"""Time the fixed-base MSM's bucket stage after K4 on one GPU: the whole
weighted bucket reduction (``msm2._bucket_reduce``) at 2^15 buckets (a
2^16 commit) and 2^13 (``msm_device2`` at a 2^17 witness), the suffix pass
of the bucket totals over 4,096 column-end carries (the commit's level 3),
the device-busy time of a 2^16 commit under ``torch.profiler``, the kernels
that run the complete add on a commit's own inputs (K2 on the 2^15-row adds
of ``_bucket_totals``, K4 in complete mode on the level-1 sequence and the
level-2 carries, B6 in complete mode on the first two stages of a 2^16
``msm_device2``), and the latency of one complete add (``xyzz_add``) and
one doubling: a chain of them on one warp, and the card's rate with 256
threads on each SM (the probe ``nt_chain_probe`` in
``csrc/ubench_kernels.cu``).

    python3 nova_tpu_torch/perf/bucket_stage.py [--root DIR] [--label NAME]
        [--key-cache DIR] [--out FILE]

``--root`` (default: this checkout) imports ``nova_tpu_torch`` from another
checkout of the repository, so two versions can be timed on one card; the
probe runs only where that version has it. Each function is timed twice:
CUDA events around the call (host enqueue included) and its device-busy
time under ``torch.profiler`` (every kernel, fill and copy it launches, with
the largest by name). Where that version has no one-launch suffix pass
(``msm3.suffix_to_buckets``), its Hillis-Steele rounds
(``msm3._suffix_segmented``) and the run-head gather (``msm3._take``) are
timed instead: the same function. ``--key-cache`` shares one derived 2^16
commit key between the runs. Tables and carries are seeded random field
elements (every add takes the general path); the carries' digits are
distinct and sorted, as a commit's level-2 carries are. Prints one JSON
object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 7
SEED = 5
N_COMMIT = 1 << 16


def _ms(torch, fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _rand_rows(torch, np, rng, n: int):
    """(n, 16) int32 limbs of random field elements below p, on the card."""
    v = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    v[:, 15] &= 0x3FFF  # < 2^254 < p for both Pallas fields
    return torch.from_numpy(v.astype(np.int32)).cuda()


def _busy_ms(torch, fn, reps: int = 5):
    """Device-busy ms per call of fn under torch.profiler, wall ms per call
    (host clock) and the device ms per call of its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
            rows.append((us / 1e3 / reps, ev.count / reps, ev.key[:60]))
    rows.sort(reverse=True)
    return {"busy_ms": sum(r[0] for r in rows), "wall_ms": wall,
            "top": [[ms, calls, key] for ms, calls, key in rows[:6]]}


CHAIN_STEPS = 16
CHAIN_MODES = ("xyzz_add", "xyzz_double")


def _chain(torch, np, rng, tf, _build):
    """us per step of a chained add or doubling on one warp, and steps per
    us on 132 blocks of 256 threads; random field elements, so every add
    takes the general path."""
    rows = 132 * 256
    pts = [_rand_rows(torch, np, rng, rows) for _ in range(4)]
    outs = [torch.empty_like(pts[0]) for _ in range(4)]
    res = {}
    for mode, name in enumerate(CHAIN_MODES):
        for blocks, threads, label in ((1, 32, "one_warp_us"), (132, 256, "card_per_us")):
            def run():
                err = _build.lib().nt_chain_probe(
                    mode, *(t.data_ptr() for t in pts), *(t.data_ptr() for t in outs),
                    CHAIN_STEPS, rows, blocks, threads, tf.consts_ptr,
                    _build.stream_of(pts[0]))
                _build.check(err, "chain_probe")
            us = _ms(torch, run) * 1e3
            res.setdefault(name, {})[label] = (
                us / CHAIN_STEPS if blocks == 1 else blocks * threads * CHAIN_STEPS / us)
    return res


def _calls(targets: dict):
    """Install recorders on {name: (module, attribute)}; returns the list of
    each name's call arguments and a function that removes them."""
    seen, saved = {name: [] for name in targets}, []
    for name, (mod, attr) in targets.items():
        real = getattr(mod, attr)
        saved.append((mod, attr, real))

        def wrapper(*a, _name=name, _real=real, **k):
            seen[_name].append((a, k))
            return _real(*a, **k)

        setattr(mod, attr, wrapper)

    def restore():
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return seen, restore


def _complete_adds(torch, fk, msm2, msm3, commit, witness_msm) -> dict:
    """Device-busy ms of the kernels that run the complete add, on the
    inputs a commit and an msm_device2 give them: K2 on the largest adds of
    _bucket_totals, K4 in complete mode on level 1 (the commit's fast pass
    rerun) and level 2, B6 in complete mode on the first two stages."""
    seen, restore = _calls({"add": (fk, "xyzz_add"), "accum": (msm3, "accum")})
    try:
        commit()
    finally:
        restore()
    rows = max(a[1]["x"].shape[0] for a, _ in seen["add"])
    res = {"k2_add_rows": int(rows), "k2_add": []}
    for (tf, P, Q), _ in seen["add"]:
        if P["x"].shape[0] == rows:
            res["k2_add"].append(_busy_ms(torch, lambda: fk.xyzz_add(tf, P, Q)))
    for level, (a, _) in zip(("l1", "l2"), seen["accum"]):
        args = a[:4] + ("complete",) + a[5:]
        res[f"k4_complete_{level}"] = _busy_ms(torch, lambda: msm3.accum(*args))
    seen, restore = _calls({"stage": (msm2, "stage")})
    try:
        witness_msm()
    finally:
        restore()
    for label, (a, k) in zip(("first", "later"), seen["stage"]):
        tf, rounds, masks, pts = a[:4]
        live = k.get("live")
        res[f"b6_complete_{label}"] = _busy_ms(
            torch, lambda: msm2.stage(tf, rounds, masks, pts, "complete", live))
        res[f"b6_complete_{label}"]["lanes"] = int(masks.shape[1])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--key-cache", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bucket_stage: no CUDA device", file=sys.stderr)
        return 2
    import nova_tpu_torch
    from nova_tpu_torch import _build
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops import msm2, msm3
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.provider import pedersen

    if args.key_cache:
        os.makedirs(args.key_cache, exist_ok=True)
        pedersen._KEY_CACHE_DIR = os.path.abspath(args.key_cache)
    _build.lib()
    tf = TField(pallas.base)
    rng = np.random.default_rng(SEED)
    keys = ("x", "y", "zz", "zzz")
    res = {"label": args.label, "package": os.path.dirname(nova_tpu_torch.__file__),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               stdout=subprocess.PIPE, text=True).stdout.strip()}
    if hasattr(_build.lib(), "nt_chain_probe"):
        res["chain"] = _chain(torch, np, rng, tf, _build)
    for nb in (1 << 15, 1 << 13):
        table = {k: _rand_rows(torch, np, rng, nb) for k in keys}
        res[f"bucket_reduce_{nb}_ms"] = _ms(torch, lambda: msm2._bucket_reduce(tf, table))
        res[f"bucket_reduce_{nb}_device"] = _busy_ms(
            torch, lambda: msm2._bucket_reduce(tf, table))

    m, nb = 4096, 1 << 15
    digs = torch.from_numpy(np.sort(rng.choice(np.arange(1, nb + 1), m, replace=False))
                            .astype(np.int32)).cuda()
    vals = {k: _rand_rows(torch, np, rng, m) for k in keys}
    if hasattr(msm3, "suffix_to_buckets"):
        def suffix():
            return msm3.suffix_to_buckets(tf, digs, vals, nb)
    else:
        bs = torch.arange(1, nb + 1, dtype=digs.dtype, device=digs.device)

        def suffix():
            return msm3._take(msm3._suffix_segmented(tf, digs, vals),
                              *msm3._run_heads(digs, bs))
    res["suffix_4096_ms"] = _ms(torch, suffix)
    res["suffix_4096_device"] = _busy_ms(torch, suffix)

    ck = pedersen.CommitmentEngine.setup(pallas, b"bench-msm", N_COMMIT - 1, device="cuda")
    order = pallas.scalar.p
    raw = rng.bytes(32 * N_COMMIT)
    scal = [int.from_bytes(raw[32 * i: 32 * i + 32], "little") % order
            for i in range(N_COMMIT)]
    v = FVec.from_ints(pallas.scalar, scal, device="cuda")
    pedersen.CommitmentEngine.commit(ck, v)  # the key's window precompute
    _build.reset_launches()
    pedersen.CommitmentEngine.commit(ck, v)
    torch.cuda.synchronize()
    res["commit_launches"] = {k: c for k, c in _build.LAUNCHES.items() if c}
    res["commit_device"] = _busy_ms(torch, lambda: pedersen.CommitmentEngine.commit(ck, v))
    t0 = time.perf_counter()
    for _ in range(REPS):
        pedersen.CommitmentEngine.commit(ck, v)
    res["commit_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    db = ck.device_bases2(N_COMMIT)
    msm2.msm_device2(scal, device_bases=db, reuse=True)  # the window precompute
    res["complete_add"] = _complete_adds(
        torch, fk, msm2, msm3, lambda: pedersen.CommitmentEngine.commit(ck, v),
        lambda: msm2.msm_device2(scal, device_bases=db, reuse=True))
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
