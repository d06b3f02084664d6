#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device Pedersen commit on one GPU.

    python3 chip_smoke.py                # full run: 2^16 Pallas points, window 16
    python3 chip_smoke.py --log-n 12     # a shorter run
    python3 chip_smoke.py --profile      # plus a torch.profiler breakdown
    python3 chip_smoke.py --rehearse --log-n 10   # CPU dry run, plain versions

Phases (each fatal; on failure the script exits non-zero and prints no
result line):

1. build: require CUDA, build the kernels from nova_tpu_torch/csrc with
   nvcc, print the build time, registers/spills and the card's name and
   power limit;
2. main path: CommitmentEngine.setup(pallas, b"bench-msm", 2^n - 1), a
   commit of a seeded full-width FVec, a batch_commit of 4 vectors and a
   commit_small of 16-bit scalars, with every kernel's launch count reset
   just before and read just after; results held against the host
   Pippenger (msm_host) and batch against sequential;
3. each kernel against its plain PyTorch version on the main path's
   shapes (K1 at 2^20 elements of both Pallas fields, K2/K3 at 2^16 lanes
   with identity, P = Q and P = -Q lanes, K4 on the real (R, C) grid in
   fast/complete affine and fast/complete XYZZ modes, K5 on the real
   2^15-bucket table),
   compared bitwise;
4. timing with CUDA events (median of 5 runs after warm-up): each
   kernel and its plain version, and the msm3m workload (sequential and
   batch-of-4 points/s).

The last lines are the card's name and power limit, one JSON object
{"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# Montgomery product on 8 x 32-bit words: 64 + 64 word products (a*b, m*p),
# each two int32 multiply-adds (low and high halves), plus 8 for m = t*n0.
MUL_OPS = 2 * (64 + 64) + 8
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (NVIDIA H100
# architecture white paper); 3.35 TB/s HBM3 (NVIDIA data sheet).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
ROW = 64  # bytes of one (16,) int32 limb row
SEED = 20260

REPLACES = {
    "mont_mul": "nova_tpu/fields/pallas_kernels.py:85",
    "xyzz_add": "nova_tpu/fields/pallas_kernels.py:337",
    "xyzz_double": "nova_tpu/fields/pallas_kernels.py:360",
    "accum": "nova_tpu/ops/msm3.py:221",
    "bucket_reduce": "nova_tpu/ops/msm2.py:666",
}
SOURCE = {
    "mont_mul": "nova_tpu_torch/csrc/field_kernels.cu",
    "xyzz_add": "nova_tpu_torch/csrc/field_kernels.cu",
    "xyzz_double": "nova_tpu_torch/csrc/field_kernels.cu",
    "accum": "nova_tpu_torch/csrc/msm_kernels.cu",
    "bucket_reduce": "nova_tpu_torch/csrc/msm_kernels.cu",
}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() between CUDA events, after one warm-up
    (host clock in a --rehearse run, which has no card)."""
    fn()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if not cuda:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_b = nbytes / BYTES_PER_S * 1e3
    t_o = ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(torch, a: dict, b: dict) -> int:
    err = 0
    for k in a:
        err = max(err, int((a[k].long() - b[k].long()).abs().max().item()))
    return err


def _host_msm_part(args):
    from nova_tpu_torch.curves.msm_host import msm

    scalars, bases = args
    p = msm(scalars, bases)
    return p.x, p.y, p.infinity


def host_msm_parallel(curve, scalars, bases, workers: int):
    """The port's host Pippenger over `workers` processes, summed."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from nova_tpu_torch.curves.spec import AffinePoint

    step = -(-len(scalars) // workers)
    parts = [(scalars[i : i + step], bases[i : i + step])
             for i in range(0, len(scalars), step)]
    acc = AffinePoint.identity(curve)
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        for x, y, inf in ex.map(_host_msm_part, parts):
            acc = acc.add(AffinePoint(curve, x, y, inf))
    return acc


def profile_commits(torch, engine, ck, v, reps: int) -> None:
    """torch.profiler over `reps` sequential commits: device-busy share of
    the wall time and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    engine.commit(ck, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.commit(ck, v)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []  # device-side events only: an aten op also reports its kernels
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: {reps} commits, wall {wall_us / reps / 1e3:.3f} ms/commit, "
        f"device busy {busy / reps / 1e3:.3f} ms/commit "
        f"({100 * busy / wall_us:.1f}% of wall)")
    for dev_us, count, key in rows[:15]:
        log(f"profile:   {dev_us / reps / 1e3:8.3f} ms/commit  "
            f"{count // reps:5d} calls  {key[:90]}")


def run(args) -> dict:
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is False")
    try:
        from nova_tpu_torch import _build
    except ImportError as exc:
        raise PhaseError(f"nova_tpu_torch is not importable: {exc}")
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.fields.spec import pallas_base, pallas_scalar
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops import msm2, msm3
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    dev = torch.device("cpu" if args.rehearse else "cuda")
    workers = max(1, min(8, os.cpu_count() or 1))
    n = 1 << args.log_n
    # on CPU tensors the MSM caps the window at 9 (msm3._effective_window)
    c = 9 if args.rehearse else 16
    reps = 1 if args.rehearse else 5

    # -- phase 1: build -------------------------------------------------
    log(f"== phase 1: build ({torch.__version__}, CUDA {torch.version.cuda})")
    smi = "rehearsal on the CPU: no card"
    if not args.rehearse:
        t0 = time.perf_counter()
        _build.lib()
        log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_info})")
        with open(os.path.join(_build.build_info["dir"], "ptxas.log")) as fh:
            for line in fh:
                if "registers" in line or "spill" in line or line.startswith("=="):
                    log("ptxas: " + line.rstrip())
        smi = smi_line()
    log(f"card: {smi}")

    # -- phase 2: the main path -------------------------------------------
    log(f"== phase 2: main path (pallas, n = 2^{args.log_n}, window {c})")
    t0 = time.perf_counter()
    ck = CommitmentEngine.setup(pallas, b"bench-msm", n - 1, device=dev,
                                workers=workers)
    log(f"setup: {len(ck.ck)} generators in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    order = pallas.scalar.p

    def full_scalars(k):
        raw = rng.bytes(32 * k)
        return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") % order
                for i in range(k)]

    scal = full_scalars(n)
    batch = [full_scalars(n) for _ in range(4)]
    small = [int(x) for x in rng.integers(0, 1 << 16, size=n)]

    _build.reset_launches()
    t0 = time.perf_counter()
    v = FVec.from_ints(pallas.scalar, scal, device=dev)
    com = CommitmentEngine.commit(ck, v)
    vs = [FVec.from_ints(pallas.scalar, s, device=dev) for s in batch]
    bcoms = CommitmentEngine.batch_commit(ck, vs, [0] * 4)
    com_small = CommitmentEngine.commit_small(ck, small)
    if not args.rehearse:
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    missing = [k for k, x in launches.items() if x == 0]
    if missing and not args.rehearse:
        raise PhaseError(f"kernels not launched on the main path: {missing}")

    seq = [CommitmentEngine.commit(ck, x) for x in vs]
    if [b.point for b in bcoms] != [s.point for s in seq]:
        raise PhaseError("batch_commit != sequential commits")
    t0 = time.perf_counter()
    want = host_msm_parallel(pallas, scal, ck.ck[:n], workers)
    if com.point != want:
        raise PhaseError(f"commit {com.point} != host msm {want}")
    want_small = host_msm_parallel(pallas, small, ck.ck[:n], workers)
    if com_small.point != want_small:
        raise PhaseError(f"commit_small {com_small.point} != host {want_small}")
    log(f"commit == host msm_host, batch == sequential, commit_small == host "
        f"({time.perf_counter() - t0:.1f} s of host checks)")

    # -- phase 3: each kernel against its plain version --------------------
    log("== phase 3: kernels against their plain versions (bitwise)")
    bf = TField(pallas_base)
    sf = TField(pallas_scalar)
    errs, timed = {}, {}
    m16 = rng.integers(0, 1 << 16, size=(1 << 20, 2, 16), dtype=np.int64)
    m16[:, :, 15] &= 0x3FFF  # < 2^254 < p for both Pallas fields
    worst = 0
    for tf in (bf, sf):
        a = torch.from_numpy(m16[:, 0].astype(np.int32)).to(dev)
        b = torch.from_numpy(m16[:, 1].astype(np.int32)).to(dev)
        edge = torch.from_numpy(tf.pack([0, 1, tf.spec.p - 1, tf.spec.p - 2])).to(dev)
        a[:4] = edge
        b[4:8] = edge
        got = fk.mont_mul(tf, a, b)
        ref = tf.ops(dev).mul(a.long(), b.long())
        worst = max(worst, int((got.long() - ref).abs().max().item()))
    errs["mont_mul"] = worst
    k1_in = (a, b)

    db = ck.device_bases2(n)
    n_pad = max(512, 1 << (n - 1).bit_length())
    fx, fy, fyneg, finf = db.fixed(c, n_pad)
    o = bf.ops(dev)
    L = min(1 << 16, n)
    one = bf.one_mont(fx[:L])
    P = {"x": fx[:L], "y": fy[:L], "zz": one.clone(), "zzz": one.clone()}
    Qd = fk.xyzz_double_limbs(o, tuple(t.long() for t in (fx[L:2 * L], fy[L:2 * L], one, one)))
    Q = {k: t.to(torch.int32) for k, t in zip(fk.KEYS, Qd)}
    for k in ("zz", "zzz"):
        P[k][0:8] = 0   # P identity
        Q[k][8:16] = 0  # Q identity
        P[k][32:40] = 0
        Q[k][32:40] = 0  # both identity
    for k in fk.KEYS:
        Q[k][16:24] = P[k][16:24]  # P = Q
        Q[k][24:32] = P[k][24:32]
    Q["y"][24:32] = bf.neg(P["y"][24:32])  # P = -Q
    got = fk.xyzz_add(bf, P, Q)
    ref = fk.xyzz_add_limbs(o, tuple(P[k].long() for k in fk.KEYS),
                            tuple(Q[k].long() for k in fk.KEYS))
    errs["xyzz_add"] = max_abs_err(torch, got, dict(zip(fk.KEYS, ref)))
    D = {k: t.clone() for k, t in Q.items()}
    got = fk.xyzz_double(bf, D)
    ref = fk.xyzz_double_limbs(o, tuple(D[k].long() for k in fk.KEYS))
    errs["xyzz_double"] = max_abs_err(torch, got, dict(zip(fk.KEYS, ref)))

    W = msm3._windows_for(c, pallas.scalar.p)
    sorted_d, st = msm3._prep_mont(db, v.m, c, W)
    d_grid, pts = st
    R, C = d_grid.shape
    log(f"K4 grid: R = {R}, C = {C} (n_s = {R * C})")
    acc_err = 0
    for mode in ("fast", "complete"):
        got = msm3.accum(bf, d_grid, pts, mode)
        ref = msm3.accum_plain(bf, d_grid, pts, mode)
        acc_err = max(acc_err, max_abs_err(torch, got[0], ref[0]),
                      max_abs_err(torch, got[1], ref[1]),
                      int((got[2] - ref[2]).abs().max().item()))
    flush, colend, flag = msm3.accum(bf, d_grid, pts, "fast")
    dend = d_grid[R - 1].contiguous()
    C2 = max(128, C // msm3._R2)
    R2 = C // C2
    gi = msm3._grid_index(R2, C2, dev)
    d2 = dend[gi].view(R2, C2)
    p2 = {k: t[gi].view(R2, C2, 16) for k, t in colend.items()}
    for mode in ("fast", "complete"):
        got = msm3.accum(bf, d2, p2, mode)
        ref = msm3.accum_plain(bf, d2, p2, mode)
        acc_err = max(acc_err, max_abs_err(torch, got[0], ref[0]),
                      max_abs_err(torch, got[1], ref[1]),
                      int((got[2] - ref[2]).abs().max().item()))
    errs["accum"] = acc_err
    nb = 1 << (c - 1)
    totals = msm3._bucket_totals(bf, sorted_d, flush, colend, d_grid, nb)
    m = min(nb, msm2._GROUP)
    gS, gW = msm2.bucket_reduce_groups(bf, totals, m)
    rS, rW = msm2.bucket_reduce_groups_plain(bf, totals, m)
    errs["bucket_reduce"] = max(max_abs_err(torch, gS, rS), max_abs_err(torch, gW, rW))
    # the degenerate-add retry on the card: 8 bases repeated, so equal
    # (base, digit) pairs meet in a column and the fast pass flags them
    rep = (ck.ck[:8] * (n // 8))[: min(n, 4096)]
    small_rep = [int(x) for x in rng.integers(0, 1 << 16, size=len(rep))]
    db_rep = msm2.DeviceBases2(pallas, rep, device=dev)
    before = _build.LAUNCHES["accum"]
    got = msm3.msm_device3(small_rep, device_bases=db_rep, window=c)
    passes = _build.LAUNCHES["accum"] - before
    if got != host_msm_parallel(pallas, small_rep, rep, workers):
        raise PhaseError("repeated-base MSM != host msm")
    n_rep = max(512, len(rep))
    _, c_rep = msm3._grid_shape(msm3._windows_for(c, order) * n_rep)
    per_pass = 1 if c_rep <= 256 else 2  # level 1, plus level 2 when C > 256
    log(f"repeated bases: equal to the host msm; K4 launches {passes} "
        f"(expected {2 * per_pass}: fast pass + complete rerun)")
    if not args.rehearse and passes != 2 * per_pass:
        raise PhaseError("repeated bases did not take the complete rerun")
    log(f"max |kernel - plain| over limbs: {errs}")
    bad = {k: e for k, e in errs.items() if e != 0}
    if bad:
        raise PhaseError(f"kernels disagree with their plain versions: {bad}")

    # -- phase 4: timing ----------------------------------------------------
    log(f"== phase 4: timing (median of {reps})")
    a, b = k1_in
    mont_n = a.shape[0]
    timed["mont_mul"] = (
        cuda_ms(torch, lambda: fk.mont_mul(sf, a, b), reps),
        cuda_ms(torch, lambda: sf.ops(dev).mul(a.long(), b.long()), max(1, reps // 2)),
        bound(3 * ROW * mont_n, MUL_OPS * mont_n),
    )
    pz = P["zz"].eq(0).all(-1)
    qz = Q["zz"].eq(0).all(-1)
    both = (~pz & ~qz)
    n_dbl = int(both[16:24].sum())
    n_inv = int(both[24:32].sum())
    n_gen = int(both.sum()) - n_dbl - n_inv
    add_ops = MUL_OPS * (14 * n_gen + 13 * n_dbl + 4 * n_inv)
    Pl = tuple(P[k].long() for k in fk.KEYS)
    Ql = tuple(Q[k].long() for k in fk.KEYS)
    timed["xyzz_add"] = (
        cuda_ms(torch, lambda: fk.xyzz_add(bf, P, Q), reps),
        cuda_ms(torch, lambda: fk.xyzz_add_limbs(o, Pl, Ql), max(1, reps // 2)),
        bound(12 * ROW * L, add_ops),
    )
    n_live = int((~D["zz"].eq(0).all(-1)).sum())
    Dl = tuple(D[k].long() for k in fk.KEYS)
    timed["xyzz_double"] = (
        cuda_ms(torch, lambda: fk.xyzz_double(bf, D), reps),
        cuda_ms(torch, lambda: fk.xyzz_double_limbs(o, Dl), max(1, reps // 2)),
        bound(8 * ROW * L, MUL_OPS * 9 * n_live),
    )
    repeat = (d_grid[1:] == d_grid[:-1]) & (d_grid[1:] != 0)
    k4_ops = MUL_OPS * 10 * int(repeat.sum())
    k4_bytes = R * C * (4 + 2 * ROW + 4 * ROW) + C * (4 * ROW + 4)
    timed["accum"] = (
        cuda_ms(torch, lambda: msm3.accum(bf, d_grid, pts, "fast"), reps),
        cuda_ms(torch, lambda: msm3.accum_plain(bf, d_grid, pts, "fast"), 1),
        bound(k4_bytes, k4_ops),
    )
    logm = m.bit_length() - 1
    adds = (nb // m) * sum(m - (1 << (r % logm)) for r in range(2 * logm))
    timed["bucket_reduce"] = (
        cuda_ms(torch, lambda: msm2.bucket_reduce_groups(bf, totals, m), reps),
        cuda_ms(torch, lambda: msm2.bucket_reduce_groups_plain(bf, totals, m), 1),
        bound(4 * ROW * nb + 8 * ROW * (nb // m), MUL_OPS * 14 * adds),
    )

    _build.reset_launches()
    CommitmentEngine.commit(ck, v)
    per_msm = dict(_build.LAUNCHES)
    seq_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        CommitmentEngine.commit(ck, v)
        seq_s.append(time.perf_counter() - t0)
    bat_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        CommitmentEngine.batch_commit(ck, vs, [0] * 4)
        bat_s.append(time.perf_counter() - t0)
    msm = {
        "n": n, "window": c, "grid": [R, C],
        "seq_ms": statistics.median(seq_s) * 1e3,
        "seq_pts_per_s": n / statistics.median(seq_s),
        "batch4_ms": statistics.median(bat_s) * 1e3,
        "pipelined_pts_per_s": 4 * n / statistics.median(bat_s),
        "launches_per_msm": per_msm,
    }
    log("msm3m: " + json.dumps(msm))
    if args.profile:
        profile_commits(torch, CommitmentEngine, ck, v, reps)

    rows = []
    for name in REPLACES:
        ms, plain_ms, (b_ms, b_by) = timed[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    return {"smi": smi, "kernels": rows, "msm": msm}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=16, help="MSM size 2^n")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over sequential commits")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU with the plain versions (no card, "
                         "no result line); use with --log-n 10")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: FAILED: torch missing: {exc}", file=sys.stderr)
        return 2
    try:
        res = run(args)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if args.rehearse:
        print(json.dumps({"kernels": res["kernels"]}))
        print("chip_smoke: rehearsal finished (no card: no result)")
        return 3
    print(res["smi"])
    print(json.dumps({"kernels": res["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
