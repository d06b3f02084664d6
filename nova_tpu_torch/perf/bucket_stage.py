"""Time the field product, K1, K2, K3 and P1/P2, and the fixed-base MSM's
bucket stage after K4 on one GPU. First the Montgomery product
(``fe_mul``): a chain of products on one warp and the card's rate (probe
mode 2), K1's device time at the shapes its callers give it (the 2^20-row
check, the commit's ``from_mont`` of its 2^16 scalars, the fold step's
``FVec.axpy`` at 2^17, the SpMV product over 2^17 nonzeros, the device
outer sumcheck's round products and its bind at 2^17), each against its
plain version, K2 on 2^15 random rows, P1 and P2 at the microbenchmark's
2^18 x 20, and every kernel's registers and spills (``ptxas.log``). K3 on
one window of a key's window precompute and the whole precompute, wall
and device-busy, at the 2^16 commit key's shape (16 doublings a window)
and the 2^17 witness key's (14). Then the whole
weighted bucket reduction (``msm2._bucket_reduce``) at 2^15 buckets (a
2^16 commit) and 2^13 (``msm_device2`` at a 2^17 witness), the suffix pass
of the bucket totals over 4,096 column-end carries (the commit's level 3),
the device-busy time of a 2^16 commit under ``torch.profiler``, the kernels
that run the complete add on a commit's own inputs (K2 on the 2^15-row adds
of ``_bucket_totals``, K4 in complete mode on the level-1 sequence and the
level-2 carries, B6 in complete mode on the first two stages of a 2^16
``msm_device2``), and the latency of one complete add (``xyzz_add``), one
doubling and one product: a chain of them on one warp, and the card's rate
with 256 threads on each SM (the probe ``nt_chain_probe`` in
``csrc/chain_probe.cu``), with the SASS instruction count of the
product's chain loop.

    python3 nova_tpu_torch/perf/bucket_stage.py [--root DIR] [--label NAME]
        [--key-cache DIR] [--out FILE]

``--root`` (default: this checkout) imports ``nova_tpu_torch`` from another
checkout of the repository, so two versions can be timed on one card. The
probe is this checkout's ``csrc/chain_probe.cu`` built with nvcc against
the ``field.cuh`` of ``--root`` (into this checkout's ``_build/``), so both
versions run the same probe around their own product. K2's row reports
the share of the commit's add lanes whose operands are both live. Each
function is timed twice: CUDA events around the call (host enqueue
included) and its device-busy time under ``torch.profiler`` (every kernel,
fill and copy it launches, with the largest by name). Where that version
has no one-launch suffix pass (``msm3.suffix_to_buckets``), its
Hillis-Steele rounds (``msm3._suffix_segmented``) and the run-head gather
(``msm3._take``) are timed instead: the same function. ``--key-cache`` shares one derived 2^16
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


def busy_ms(torch, fn, reps: int = 5):
    """Device-busy ms per call of fn under torch.profiler, wall ms per call
    (host clock) and the device ms per call of its largest kernels. The
    profiler sometimes keeps only some of a kernel's events, so "once_ms"
    also gives the device ms of a call that launches each of its kernels
    once: each kernel's total divided by the events it kept."""
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
            "once_ms": sum(ms / calls for ms, calls, _ in rows if calls),
            "top": [[ms, calls, key] for ms, calls, key in rows[:6]]}


# probe modes and the chain length each is timed at
CHAIN_MODES = (("xyzz_add", 16), ("xyzz_double", 16), ("fe_mul", 256))
_HERE = os.path.dirname(os.path.abspath(__file__))


def _probe_lib(root: str, _build):
    """This checkout's csrc/chain_probe.cu built against the field.cuh of
    the checkout at `root`, loaded with ctypes (built once per pair)."""
    import ctypes
    import hashlib
    import shutil

    src = os.path.join(_HERE, "..", "csrc", "chain_probe.cu")
    hdr = os.path.join(root, "nova_tpu_torch", "csrc", "field.cuh")
    h = hashlib.sha256()
    for f in (src, hdr):
        with open(f, "rb") as fh:
            h.update(fh.read())
    out = os.path.join(_HERE, "..", "_build", "probe-" + h.hexdigest()[:16])
    so = os.path.join(out, "libprobe.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        shutil.copy(src, out)
        shutil.copy(hdr, out)
        subprocess.run(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared",
             os.path.join(out, "chain_probe.cu"), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.nt_chain_probe.argtypes = _build._SIGNATURES["nt_chain_probe"]
    lib.nt_chain_probe.restype = ctypes.c_int
    return lib


def _sass_loop(so: str, kernel: str, nvcc: str) -> dict:
    """SASS of the probe's chain loop (the instructions between a backward
    branch and its target) in the kernel whose mangled name contains
    `kernel`: instruction count by opcode, from cuobjdump -sass."""
    import re

    text = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
                          stdout=subprocess.PIPE, text=True).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if inside:
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                body.append(("label", m.group(1)))
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*)", line)
            if m:
                body.append((m.group(2), m.group(3)))
    labels = {arg: i for i, (op, arg) in enumerate(body) if op == "label"}
    loops = [(labels[t.group(1)], i) for i, (op, arg) in enumerate(body)
             if op.startswith("BRA") and (t := re.search(r"(\.L_x_\d+)", arg))
             and labels.get(t.group(1), i) < i]
    lo, hi = max(loops, key=lambda ab: ab[1] - ab[0]) if loops else (0, len(body))
    ops = {}
    for op, _ in body[lo:hi + 1]:
        if op != "label":
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    return {"instructions": sum(ops.values()),
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def chain_probe(torch, np, rng, tf, _build, lib):
    """us per step of a chained add, doubling or product on one warp, and
    steps per us on 132 blocks of 256 threads; random field elements, so
    every add takes the general path."""
    rows = 132 * 256
    pts = [_rand_rows(torch, np, rng, rows) for _ in range(4)]
    outs = [torch.empty_like(pts[0]) for _ in range(4)]
    res = {}
    for mode, (name, steps) in enumerate(CHAIN_MODES):
        for blocks, threads, label in ((1, 32, "one_warp_us"), (132, 256, "card_per_us")):
            def run():
                err = lib.nt_chain_probe(
                    mode, *(t.data_ptr() for t in pts), *(t.data_ptr() for t in outs),
                    steps, rows, blocks, threads, tf.consts_ptr, _build.stream_of(pts[0]))
                _build.check(err, "chain_probe")
            us = _ms(torch, run) * 1e3
            res.setdefault(name, {})[label] = (
                us / steps if blocks == 1 else blocks * threads * steps / us)
    return res


def _ptxas(_build) -> dict:
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    ptxas.log of the library in use (nvcc -Xptxas -v), names demangled by
    c++filt where it exists."""
    import re

    with open(os.path.join(_build.build_info["dir"], "ptxas.log")) as fh:
        raw = fh.read()
    try:
        raw = subprocess.run(["c++filt"], input=raw, text=True,
                             stdout=subprocess.PIPE).stdout or raw
    except OSError:
        pass
    out, cur = {}, None
    for line in raw.splitlines():
        if "Function properties for" in line:
            cur = line.split("Function properties for", 1)[1].strip()
            cur = cur.replace("(anonymous namespace)::", "").split("(")[0]
            out[cur] = [None, 0, 0]
        elif cur and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        elif cur and "Used" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    return out


def k1_shapes(torch, np, rng, tf, device="cuda", shift: int = 0):
    """K1's operands at the shapes its callers give it on the main path
    (random rows below p; `shift` divides every size by 2^shift for a CPU
    rehearsal): {label: (a, b, bytes)} where bytes counts each input row
    read once (a one-row constant once) and each output row written
    once."""
    def rows(*shape):
        v = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
        v[..., 15] &= 0x3FFF
        return torch.from_numpy(v.astype(np.int32)).to(device)

    def full(n, *, one=False):
        return 64 * n * (2 if one else 3) + (64 if one else 0)

    n16, n17, n20 = (1 << 16) >> shift, (1 << 17) >> shift, (1 << 20) >> shift
    m16, v17, lo = rows(n16), rows(n17), rows(4, n16)
    one = tf._const((1,) + (0,) * 15, m16.device)
    return {
        "check 2^20": (rows(n20), rows(n20), full(n20)),
        "commit from_mont 2^16": (m16, one, full(n16, one=True)),
        "fold axpy 2^17": (tf.const_mont(12345, v17), v17, full(n17, one=True)),
        "spmv 2^17 nonzeros": (rows(n17), rows(n17), full(n17)),
        "sumcheck round 3 x 2^16": (rows(3, n16), rows(3, n16), full(3 * n16)),
        "sumcheck bind 4 x 2^16": (tf.const_mont(54321, lo), lo, full(4 * n16, one=True)),
    }


def _k1(torch, np, rng, fk, tf) -> dict:
    """K1 at each path shape: device-busy ms (every kernel the call
    launches, so a copy of a broadcast operand shows), max |kernel - plain|,
    the bytes of its bound."""
    res = {}
    o = tf.ops("cuda")
    for label, (a, b, nbytes) in k1_shapes(torch, np, rng, tf).items():
        got = fk.mont_mul(tf, a, b)
        err = int((got.long() - o.mul(a.long(), b.long())).abs().max().item())
        res[label] = {"rows": list(got.shape[:-1]), "bytes": nbytes, "max_abs_err": err,
                      **busy_ms(torch, lambda: fk.mont_mul(tf, a, b))}
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
            o = tf.ops("cuda")
            ref = fk.xyzz_add_limbs(o, tuple(P[k].long() for k in fk.KEYS),
                                    tuple(Q[k].long() for k in fk.KEYS))
            got = fk.xyzz_add(tf, P, Q)
            live = P["zz"].ne(0).any(-1) & Q["zz"].ne(0).any(-1)
            res["k2_add"].append({
                "live_share": float(live.float().mean()),
                "max_abs_err": max(int((got[k].long() - r).abs().max())
                                   for k, r in zip(fk.KEYS, ref)),
                **busy_ms(torch, lambda: fk.xyzz_add(tf, P, Q))})
    for level, (a, _) in zip(("l1", "l2"), seen["accum"]):
        args = a[:4] + ("complete",) + a[5:]
        res[f"k4_complete_{level}"] = busy_ms(torch, lambda: msm3.accum(*args))
    seen, restore = _calls({"stage": (msm2, "stage")})
    try:
        witness_msm()
    finally:
        restore()
    for label, (a, k) in zip(("first", "later"), seen["stage"]):
        tf, rounds, masks, pts = a[:4]
        live = k.get("live")
        res[f"b6_complete_{label}"] = busy_ms(
            torch, lambda: msm2.stage(tf, rounds, masks, pts, "complete", live))
        res[f"b6_complete_{label}"]["lanes"] = int(masks.shape[1])
    return res


def _ubench(torch) -> dict:
    """P1 and P2 at the microbenchmark's 2^18 columns x 20 products: CUDA
    events around the call and device-busy ms."""
    from nova_tpu_torch.perf import ubench_field as ub

    t = ub.inputs(1 << 18, device="cuda")
    res = {}
    for name, a, b in (("mont16_chain", t["a16"], t["b16"]), ("mont8_chain", t["a8"], t["b8"])):
        fn = getattr(ub, name)
        res[name] = {"ms": _ms(torch, lambda: fn(a, b, 20)),
                     **busy_ms(torch, lambda: fn(a, b, 20))}
    return res


def _windows(torch, fk, msm2, curve, tf, db) -> dict:
    """K3 on one window of a key's precompute and the key's whole window
    precompute (K3 and the batched inversions' K1), at the 2^16 commit
    key's shape (window 16) and the 2^17 witness key's (window 14; its
    bases here are the commit key's and their negatives, the same work).
    K3 takes the window's c doublings in one launch where the version has
    a `times` argument, else in c launches. Device-busy ms under the
    profiler ("once_ms" of K3: one launch) and the precompute's wall ms."""
    import inspect

    chained = "times" in inspect.signature(fk.xyzz_double).parameters
    wide = msm2.DeviceBases2.from_tensors(
        curve, torch.cat([db.x, db.x]), torch.cat([db.y, msm2._negate_y(tf, db.y)]),
        torch.cat([db.inf, db.inf]))
    res = {"k3_one_launch_a_window": chained}
    for label, bases, c in (("commit_key_65536", db, 16), ("witness_key_131072", wide, 14)):
        bx, by, binf = msm2._sized(bases, bases.n)
        one = tf.one_mont(bx)
        pts = {"x": bx, "y": by, "zz": one, "zzz": one}

        def window():
            if chained:
                return fk.xyzz_double(tf, pts, c)
            p = pts
            for _ in range(c):
                p = fk.xyzz_double(tf, p)
            return p

        W = msm2._num_windows2(c)

        def precompute():
            return msm2._precompute_shifted(tf, c, W, bx, by, binf)

        precompute()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        precompute()
        torch.cuda.synchronize()
        res[label] = {"rows": int(bases.n), "window": c, "k3_window": busy_ms(torch, window),
                      "precompute_wall_ms": (time.perf_counter() - t0) * 1e3,
                      "precompute_device": busy_ms(torch, precompute, 1)}
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
    res["registers_spills"] = _ptxas(_build)
    probe = _probe_lib(os.path.abspath(args.root), _build)
    res["chain"] = chain_probe(torch, np, rng, tf, _build, probe)
    res["product_loop_sass"] = _sass_loop(probe._name, "point_chain_kernelILi2E",
                                          _build._nvcc())
    res["k1"] = _k1(torch, np, rng, fk, TField(pallas.scalar))
    # K2 on 2^15 random rows (every lane live)
    P = {k: _rand_rows(torch, np, rng, 1 << 15) for k in keys}
    Q = {k: _rand_rows(torch, np, rng, 1 << 15) for k in keys}
    res["k2_random_32768_device"] = busy_ms(torch, lambda: fk.xyzz_add(tf, P, Q))
    res["ubench"] = _ubench(torch)
    for nb in (1 << 15, 1 << 13):
        table = {k: _rand_rows(torch, np, rng, nb) for k in keys}
        res[f"bucket_reduce_{nb}_ms"] = _ms(torch, lambda: msm2._bucket_reduce(tf, table))
        res[f"bucket_reduce_{nb}_device"] = busy_ms(
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
    res["suffix_4096_device"] = busy_ms(torch, suffix)

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
    res["commit_device"] = busy_ms(torch, lambda: pedersen.CommitmentEngine.commit(ck, v))
    t0 = time.perf_counter()
    for _ in range(REPS):
        pedersen.CommitmentEngine.commit(ck, v)
    res["commit_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    db = ck.device_bases2(N_COMMIT)
    res["windows"] = _windows(torch, fk, msm2, pallas, tf, db)
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
