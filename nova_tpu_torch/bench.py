"""Headline benchmark of the port (the twin of the repository's
``bench.py``). Prints ONE JSON line last:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

    python -m nova_tpu_torch.bench

Primary metric: MSM throughput (points/sec/chip), 2^16 points, Pallas
curve, full 255-bit scalars, through the fixed-base engine the Pedersen
commitment path uses. Baseline: halo2curves `msm_best` at 192 ms for 2^20
points (64-bit scalars) on the reference's dev machine
(src/provider/msm.rs:493-495), i.e. 5.46M points/sec; vs_baseline = ours /
5.46e6. Every engine's first result is checked against the native host
MSM (a mismatch fails the stage).

`extra` carries:
  - backend: "cuda (<engine>)", the engine whose rate is `value`;
  - msm_pipelined_pts_per_s: msm3m's batch-of-4 rate (the batch_commit
    pattern: four MSMs queued before the first result is read);
  - host_pts_per_s: the native host MSM on the same workload, beside the
    card's rate (never the headline);
  - fold_step_ms: RecursiveSNARK.prove_step wall time (trivial step
    circuit, the Pallas/Vesta augmented pair, ~10k constraints each; the
    fourth step);
  - compressed_snark_prove_s: CompressedSNARK.prove (snark/snark + IPA) on
    that RecursiveSNARK, which must verify.

Budget (the JAX script's settings):
  - NOVA_BENCH_TOTAL_BUDGET (default 1200 s) is a wall-clock deadline;
    every stage gets a slice of what remains;
  - NOVA_BENCH_ENGINES (default msm3m,msm2,msm1) is the engine order; the
    first that completes gives `value`;
  - NOVA_BENCH_ENGINE_TIMEOUT (default 900 s) caps one engine's stage;
  - NOVA_BENCH_FAST=1 emits the MSM metric only.
Each stage runs in a watchdog subprocess with a hard timeout, which prints
the kernel library's `_build.build_info` (a `build_info` line here: a
second process finds the library built and does not rebuild it). The JSON
line is always emitted, from `finally` and from a SIGTERM/SIGINT handler.

Unlike the JAX script there is no fallback: no stage runs on the CPU in
place of the card, and the host MSM never becomes the headline. Without a
card (the probe of ``_env``) or when no engine completes, the line carries
value 0.0 and extra.error, and the script exits non-zero. ``main(device=
"cpu")`` runs the stages on the CPU's plain versions when a caller asks.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time

METRIC = "msm_points_per_sec_per_chip_2e16"
BASELINE = (1 << 20) / 0.192  # the reference's msm_best datum: 5.46M pts/s
MSM_LOG_N = 16
SEED = 0xBE2C
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- measurements


def _msm_inputs(n: int, device):
    """The key's first n generators (b"bench-msm", the label of the JAX
    script, disk-cached) and n seeded full-width scalars."""
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    rng = random.Random(SEED)
    ck = CommitmentEngine.setup(pallas, b"bench-msm", n - 1, device=device)
    scalars = [rng.randrange(pallas.scalar.p) for _ in range(n)]
    return ck, scalars


def _host_msm(ck, scalars):
    from nova_tpu_torch import native
    from nova_tpu_torch.curves.msm_host import msm as host_msm

    n = len(scalars)
    if native.available():
        return native.msm_cached(ck.curve, ck.host_arrays(n), native.ints_to_limbs(scalars))
    return host_msm(scalars, ck.ck[:n])


def bench_msm(engine: str = "msm2", n: int = 1 << MSM_LOG_N, device=None,
              iters: int = 3):
    """Steady-state MSM throughput (points/s) of `engine` in {msm3m, msm3,
    msm2, msm1} on `device` (CUDA unless given) at n points, the mean of
    `iters` calls after a first call (kernel load and window precompute),
    whose result must equal the native host MSM. msm3m returns (points/s,
    pipelined points/s)."""
    from nova_tpu_torch._device import resolve
    from nova_tpu_torch.curves.spec import pallas

    dev = resolve(device)
    ck, scalars = _msm_inputs(n, dev)
    bases = ck.ck[:n]
    run_pipelined = None
    if engine == "msm3m":
        # the production commit path: scalars arrive as a device-resident
        # Montgomery limb tensor (an FVec's .m, what pedersen.commit feeds
        # msm_device3_mont): no per-call host conversion or copy
        from nova_tpu_torch.ops.fvec import FVec
        from nova_tpu_torch.ops.msm2 import DeviceBases2
        from nova_tpu_torch.ops.msm3 import msm_device3_mont, msm_device3_mont_batch

        db = DeviceBases2(pallas, bases, device=dev)
        marr = FVec.from_ints(pallas.scalar, scalars, device=dev).m
        run = lambda: msm_device3_mont(marr, db)  # noqa: E731

        def run_pipelined():
            # the batch_commit pattern: K independent MSMs queued before
            # the first collect (the Spark oracle commits do this)
            K = 4
            msm_device3_mont_batch([marr] * K, db)
            t0 = time.perf_counter()
            msm_device3_mont_batch([marr] * K, db)
            return K * n / (time.perf_counter() - t0)
    elif engine == "msm3":
        from nova_tpu_torch.ops.msm2 import DeviceBases2
        from nova_tpu_torch.ops.msm3 import msm_device3

        db = DeviceBases2(pallas, bases, device=dev)
        run = lambda: msm_device3(scalars, device_bases=db)  # noqa: E731
    elif engine == "msm2":
        from nova_tpu_torch.ops.msm2 import DeviceBases2, msm_device2

        db = DeviceBases2(pallas, bases, device=dev)
        run = lambda: msm_device2(scalars, device_bases=db, reuse=True)  # noqa: E731
    elif engine == "msm1":
        from nova_tpu_torch.ops.msm import DeviceBases, msm_device

        db = DeviceBases(pallas, bases, device=dev)
        run = lambda: msm_device(scalars, device_bases=db)  # noqa: E731
    else:
        raise ValueError(f"unknown engine {engine!r}")

    got = run()  # kernel load + precompute
    want = _host_msm(ck, scalars)
    if got != want:
        raise AssertionError(f"{engine} at n = {n}: {got} != the host MSM {want}")
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    rate = n / ((time.perf_counter() - t0) / iters)
    if run_pipelined is not None:
        return rate, run_pipelined()
    return rate


def bench_msm_host(n: int = 1 << MSM_LOG_N, iters: int = 3) -> float:
    """The native host MSM's throughput (points/s) on bench_msm's
    workload: a comparison beside the card's rate, never the headline."""
    from nova_tpu_torch import native

    ck, scalars = _msm_inputs(n, "cpu")
    arrays = ck.host_arrays(n)
    sl = native.ints_to_limbs(scalars)
    native.msm_cached(ck.curve, arrays, sl)
    t0 = time.perf_counter()
    for _ in range(iters):
        native.msm_cached(ck.curve, arrays, sl)
    return n / ((time.perf_counter() - t0) / iters)


def bench_fold_and_compress(device=None):
    """(fold_step_ms, compressed_snark_prove_s) of the trivial circuit's
    RecursiveSNARK on `device` (CUDA unless given): the fourth prove_step
    timed, then CompressedSNARK prove, whose proof must verify."""
    from nova_tpu_torch._device import resolve
    from nova_tpu_torch.nova.circuit import TrivialCircuit
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    dev = resolve(device)
    c = TrivialCircuit()
    pp = PublicParams.setup(PallasEngine, VestaEngine, c, device=dev)
    rs = RecursiveSNARK.new(pp, c, [0])
    rs.prove_step(pp, c)  # base-case bump
    rs.prove_step(pp, c)  # the first fold: builds the witness tape
    rs.prove_step(pp, c)
    t0 = time.perf_counter()
    rs.prove_step(pp, c)
    fold_ms = (time.perf_counter() - t0) * 1e3

    pk, vk = CompressedSNARK.setup(pp)
    t0 = time.perf_counter()
    proof = CompressedSNARK.prove(pp, pk, rs)
    compress_s = time.perf_counter() - t0
    proof.verify(vk, rs.i, [0])
    return fold_ms, compress_s


# ------------------------------------------------------ watchdog plumbing


def _stage_msm(engine: str, device: str) -> None:
    """Body of an engine's stage process: the rate(s) on a PTS line, the
    kernel library's build_info on a BUILD line."""
    from nova_tpu_torch import _build

    r = bench_msm(engine, device=device)
    print("BUILD", json.dumps(_build.build_info), flush=True)
    print("PTS", *(r if isinstance(r, tuple) else (r,)), flush=True)


class _Run:
    """One run's best-so-far state and the watchdog's current process."""

    def __init__(self):
        self.start = time.monotonic()
        self.total = float(os.environ.get("NOVA_BENCH_TOTAL_BUDGET", "1200"))
        self.value = None
        self.backend = None
        self.extra = {}
        self.emitted = False
        self.proc = None

    def remaining(self) -> float:
        return self.total - (time.monotonic() - self.start)

    def line(self) -> dict:
        extra = dict(self.extra)
        extra["backend"] = self.backend or "none"
        if self.value is None:
            extra.setdefault("error", "no stage completed in budget")
            return {"metric": METRIC, "value": 0.0, "unit": "points/sec",
                    "vs_baseline": 0.0, "extra": extra}
        return {"metric": METRIC, "value": round(self.value, 1), "unit": "points/sec",
                "vs_baseline": round(self.value / BASELINE, 4), "extra": extra}

    def emit(self) -> None:
        """Print the line exactly once. Signal-safe: os.write and a flag."""
        if self.emitted:
            return
        self.emitted = True
        os.write(1, (json.dumps(self.line()) + "\n").encode())

    def on_signal(self, signum, frame):  # noqa: ANN001 - signal signature
        self.emit()
        p = self.proc
        if p is not None and p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
        # a run cut by a signal must not look like a clean completion; the
        # line was flushed above
        os._exit(128 + int(signum))

    def stage(self, code: str, timeout_s: float, label: str):
        """Run `code` in a worker process with a hard timeout: {tag:
        fields} of its output lines, or None (its last error line kept in
        extra[label + "_error"]). A hung card or a failed stage costs
        one slice, not the run."""
        if timeout_s <= 5:
            self.extra[f"{label}_error"] = "out of budget"
            return None
        full = f"import sys; sys.path.insert(0, {_REPO!r})\n" + code
        try:
            # its own process group: a kill also stops what it started (a
            # key derivation's worker pool)
            self.proc = subprocess.Popen(
                [sys.executable, "-u", "-c", full],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True,
            )
            out, err = self.proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
            self.extra[f"{label}_error"] = f"timed out after {timeout_s:.0f} s"
            return None
        finally:
            p, self.proc = self.proc, None
            if p is not None and p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        if p.returncode != 0:
            tail = [ln for ln in err.splitlines() if ln.strip()]
            self.extra[f"{label}_error"] = tail[-1] if tail else f"exit {p.returncode}"
            return None
        got = {}
        for ln in out.splitlines():
            tag, _, rest = ln.partition(" ")
            got[tag] = rest
        return got

    def guarded(self, device) -> None:
        # this process only starts the stages: it selects the card by name,
        # without importing torch
        from nova_tpu_torch._env import device_name

        try:
            dev = device_name(device)
        except RuntimeError as exc:
            self.extra["error"] = str(exc)
            return
        kind = dev.split(":")[0]

        # stage 1: the card's engines, in order; the first that completes
        # gives the headline
        order = os.environ.get("NOVA_BENCH_ENGINES", "msm3m,msm2,msm1").split(",")
        for eng in (e.strip() for e in order if e.strip()):
            slice_s = min(float(os.environ.get("NOVA_BENCH_ENGINE_TIMEOUT", "900")),
                          self.remaining() - 30)
            got = self.stage(
                f"from nova_tpu_torch import bench\n"
                f"bench._stage_msm({eng!r}, {dev!r})\n", slice_s, eng)
            if got and "PTS" in got:
                print(f"build_info {eng} {got.get('BUILD', '{}')}", flush=True)
                vals = [float(x) for x in got["PTS"].split()]
                self.value, self.backend = vals[0], f"{kind} ({eng})"
                if len(vals) > 1:
                    self.extra["msm_pipelined_pts_per_s"] = round(vals[1], 1)
                break
        else:
            self.extra["error"] = f"no {kind} engine completed ({','.join(order)})"
            return
        if os.environ.get("NOVA_BENCH_FAST"):
            return

        # stage 2: the native host MSM beside the card's rate
        got = self.stage("from nova_tpu_torch import bench\n"
                         "print('PTS', bench.bench_msm_host(), flush=True)\n",
                         min(300.0, self.remaining() * 0.3), "host")
        if got and "PTS" in got:
            self.extra["host_pts_per_s"] = round(float(got["PTS"]), 1)

        # stage 3: fold step and compression, with comfortable headroom
        if self.remaining() < 240:
            self.extra["fold_error"] = "out of budget"
            return
        got = self.stage(
            "from nova_tpu_torch import bench\n"
            f"f, c = bench.bench_fold_and_compress({dev!r})\n"
            "print('FC', f, c, flush=True)\n", self.remaining() - 60, "fold")
        if got and "FC" in got:
            f, c = (float(x) for x in got["FC"].split())
            self.extra["fold_step_ms"] = round(f, 1)
            self.extra["compressed_snark_prove_s"] = round(c, 2)


def main(device=None) -> int:
    """Run the stages on `device` (the card unless "cpu") and print the
    line; returns the exit code: 0 when an engine gave the headline."""
    run = _Run()
    handlers = {s: signal.signal(s, run.on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        run.guarded(device)
    finally:
        run.emit()
        for s, h in handlers.items():
            signal.signal(s, h)
    return 0 if run.value is not None else 1


if __name__ == "__main__":
    sys.exit(main())
