#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the device Pedersen commit, the
IVC fold step (RecursiveSNARK.prove_step) at a 2^17-constraint primary, its
compression (CompressedSNARK), the same on BN254/Grumpkin with a
powers-of-tau key and HyperKZG and Mercury compression, its compression
with the preprocessing Spartan (ppsnark), DirectSNARK with ppsnark on
Pallas, the SHA-256 step circuit's IVC, NeutronNova's IVC, checkpoints and
proofs as bytes, the device mesh (sharded MSM, a meshed fold step and
compression, the graft_entry twin), the entry points (the bench.py twin,
MinRoot at 2^15 iterations a step), and the field microbenchmark.

    python3 chip_smoke.py                # 2^16 commit, 2^17 fold steps
    python3 chip_smoke.py --profile      # plus a torch.profiler breakdown
    python3 chip_smoke.py --rehearse     # CPU dry run at 2^10 / 2^14 (a
                                         # power-18 ptau file, ppsnark's
                                         # commits on the native host MSM,
                                         # a 500-square DirectSNARK, a
                                         # 3-byte SHA-256 message, a 2^14
                                         # Neutron structure, MinRoot at 8
                                         # iterations a step, a
                                         # 2^10-column microbenchmark),
                                         # plain versions, no result

The test ptau file of phases 9-10 is written once into
nova_tpu_torch/_build/ptau/ (git-ignored) and reused by later runs; nothing
is downloaded.

Phases (each fatal; on failure the script exits non-zero and prints no
result line):

1. build: require CUDA, build the kernels from nova_tpu_torch/csrc with
   nvcc and, meanwhile, the native host binding from native/nova_native.cpp
   with g++ (required), print the build time, registers/spills and the
   card's name and power limit;
2. main path: CommitmentEngine.setup(pallas, b"bench-msm", 2^n - 1), a
   commit of a seeded full-width FVec, a batch_commit of 4 vectors and a
   commit_small of 16-bit scalars, with every kernel's launch count reset
   just before and read just after; results held against the host
   Pippenger (msm_host) and batch against sequential;
3. each kernel against its plain PyTorch version on the main path's
   shapes (K1 at 2^20 elements of every field of fields/spec.py, most
   operands in [p, 2^256), with edge values and a one-row operand on
   either side; K2/K3 at 2^16 lanes with identity, P = Q and P = -Q lanes,
   K3 with 1 and 16 chained doublings (a window's) and Y = 0 lanes too,
   and K2 on 2^16 random rows with identity lanes; K4 on the commit's
   sorted sequence (level 1: affine bases read through the sort
   permutation) and on its column carries (level 2: XYZZ), each in fast
   and complete mode; K2s, K5 and K2 on what a commit gives them: the
   4,096 level-2 carries, the 2^15-bucket table, the 2^15-row adds; K2s
   also on the commit's 32,768 level-1 carries, whose digits repeat, and
   on a 4,096-carry column with runs across its slices and 0 / -1
   padding), compared bitwise (K4: the tail table, the carries and the
   flags);
4. timing with CUDA events (median of 5 runs after warm-up): each
   kernel and its plain version, K2 and K3 at the path's shapes (K2 on
   2^15 rows, K3 on a window of the key's precompute: 2^16 rows x 16
   doublings, and each on one row); device ms under torch.profiler of K1
   at its callers' shapes (nova_tpu_torch/perf/bucket_stage.py::k1_shapes),
   of K2 on the 2^15-row adds and of K3 on the window, each beside its
   bound; the commit key's window precompute, wall and device-busy ms;
   the probe's chained product, add and doubling (one warp, and the
   card's rate); and the msm3m workload (sequential and batch-of-4
   points/s);
5. the fold step: PublicParams.setup(Pallas, Vesta, a squaring chain of
   2^17 - 9,818 constraints) on CUDA, then RecursiveSNARK.new, 5
   prove_steps (the bump, the tape build, 3 timed replays, split by the
   profiling phases) and verify, whose output must be z0^(2^(5 * squares));
   the counts are reset just before new and read just after verify, every
   kernel of the path must have launched and B6 on every step that folds;
6. fold-step checks: one fresh primary witness committed by msm_device2,
   msm_device3 and the host Pippenger (equal); B6 in all three modes against
   its plain version on the stage inputs of that commit (bitwise, equal
   flags) and timed; K1-K5 and K2s against their plain versions on the
   inputs the fold step gives them (bitwise): K1/K3 in the witness key's
   window precompute (K3 timed there at 2^17 rows x 14 doublings, and the
   key's whole precompute, wall and device-busy), K5 in the bucket
   reduction of msm_device2 (timed at its 2^13 buckets), K4, K2s and K2 in
   the commit of the running witness, K1 in the cross-term's SpMV; the
   device cross-term commit_T_device (plain and relaxed) on the padded
   square primary shape against T computed on the host; msm_device2 timed
   at the witness size and on the msm3m key and scalars; and a
   repeated-base msm_device2 that must take the complete rerun;
7. compression: CompressedSNARK.setup -> prove (split by the profiling
   phases) -> verify on phase 5's RecursiveSNARK, the counts reset just
   before setup and read just after verify (K1, K5 and B6 must have
   launched, and the primary's outer sumcheck must have taken the device
   route); K5 in the prover's largest msm_device2 against its plain
   version (bitwise); a proof with zn or the primary's eval_W changed
   must fail; the
   outer sumcheck again on the same tables through the host native loop
   must give the same proof byte for byte; K1 in the device sumcheck's
   first round against its plain version (bitwise); the randomizer's W
   commit (msm_device2) against the native host MSM;
9. BN254/Grumpkin with HyperKZG: a test ptau file at power 19 (tau drawn
   from SEED; written once, then reused; phase 10's key), PublicParams.setup_with_ptau_dir
   on CUDA with a squaring chain that pads the BN254 primary to 2^17
   constraints (its trivial augmented count read from a ShapeCS), new, 3
   prove_steps (one timed replay, by phase) and verify (z0^(2^(3 *
   squares))), CompressedSNARK with HyperKZG on the primary and IPA on the
   secondary (prove by phase) and verify; the counts reset just before new
   and read just after compression's verify: K1, K2, K2s, K4, K5 and B6
   must have launched, and K3 once a window of the KZG key's precomputes;
   proofs with zn or a HyperKZG witness changed must fail; phase 6's
   kernel checks on this path's BN254 inputs (bitwise) and each kernel
   timed there (the routing thresholds are timed by
   nova_tpu_torch/perf/thresholds.py); then CompressedSNARK with Mercury on
   the primary (prove by phase) and verify on the same RecursiveSNARK,
   proofs with zn or Mercury's g_zeta changed failing, and Mercury's
   largest msm_device2 commit against the native host MSM;
10. ppsnark on BN254/Grumpkin at phase 9's primary: setup_with_ptau_dir
   with ck hints = ppsnark's ck_floor of the ShapeCS shapes (a 2^19 KZG
   key, a 2^17 + 1 Grumpkin key), new, 3 prove_steps and verify, then
   CompressedSNARK with ppsnark on both curves (HyperKZG primary, IPA
   secondary; prove by phase: pp_outer, pp_oracles, pp_inner, pp_ee) and
   verify, the counts reset just before new and read just after
   compression's verify (every path kernel, K3 once a window of each
   precompute, the 2^19 key's among them; the primary's outer sumcheck on
   the device); proofs with zn, eval_L_row or a vk spark commitment
   changed must fail; the outer sumcheck again through the host prover
   (byte-equal); the spark row commit (N = 2^19) against the native host
   MSM, with B6 in all three modes, K1, K3 and K5 against their plain
   versions on its inputs (bitwise) and timed there; msm_device2 and the
   window precompute at N, and the native MSM of an N-entry HVec (the
   oracles' route), timed;
11. DirectSNARK with ppsnark on Pallas (a 32,700-square chain: N = 2^17,
   phase 5's key): setup (the spark commits must take msm_device2), prove,
   verify, and a changed io failing;
12. the SHA-256 IVC (benches/sha256.py's step circuit on a 128-byte
   message drawn from SEED; a ~82k-constraint Pallas primary, above
   DEVICE_THRESHOLD) with phase 5's cached keys: setup on CUDA, new, 3
   prove_steps (the bump, the tape build, one timed replay, by phase) and
   verify; the counts reset just before new and read just after verify
   (K1, K5 and B6 must launch, K3 not in the replay); the gadget's digest
   bits equal hashlib.sha256 of the message; phase 6's checks on this
   path's inputs (the fresh primary witness by msm_device2, msm_device3,
   the host Pippenger and the native host MSM; B6 in its three modes, K1,
   K3 and K5 in the rebuilt precompute, K4, K2s and K2 in the running
   witness's commit, the device cross-term; all bitwise) and each kernel
   timed at this path's shapes;
13. NeutronNova IVC on Pallas: a squaring chain fills the padded 2^17 x
   2^17 structure (the trivial augmented counts read from a ShapeCS),
   phase 5's key; setup, new, 3 prove_steps (by phase) and verify, whose
   output must be z0^(2^(3 * squares)); the counts reset just before new
   and read just after verify (K1, K5 and B6 must launch); the folded
   instance with T + 1 fails Structure.is_sat; the W commit against the
   native host MSM and B6 against its plain version on its stage inputs;
14. bytes: phase 5's RecursiveSNARK saved with checkpoint and loaded under
   the same pp (its running witness back on the card), one more
   prove_step on it and on the unbroken object with the same seeded
   randomness (equal field by field, both verify); the checkpoint loaded
   under phase 12's pp raises; phase 7's CompressedSNARK through
   proof_to_bytes / proof_from_bytes verifies, a flipped byte inside a
   point fails to load, a dumps_evm round trip gives the same bytes and
   verifies; profiling.device_trace around one replayed step writes a
   trace file;
15. the mesh (nova_tpu_torch.parallel on 4 x cuda:0: the split, the
   per-shard kernels and the exact reductions, not scaling): msm_sharded
   of phase 2's 2^16 scalars on phase 2's key, equal to msm_device3_mont
   and the host MSM and timed beside it, with K4, K2s, K5 and K1 on one
   shard's inputs and K2 on the 4-row reduction against their plain
   versions (bitwise) and timed there; a prove_step of phase 5's
   RecursiveSNARK under use_mesh against the same step without a mesh on a
   checkpoint copy, same seeded randomness, twice (equal field by field;
   the secondary's cross-term, both witnesses and the primary's cross-term
   all through msm_sharded; no K3 in the replay); graft_entry's
   dryrun_multichip(4) on the card, and a CompressedSNARK of its trivial
   circuit with and without the mesh (equal proof_to_bytes); graft_entry's
   entry() (msm1 over 256 points) against the host MSM, with every K1, K2
   and K3 call it makes against its plain version (bitwise); the counts reset
   just before each part and read just after; phase 7 also proves its
   outer sumcheck on this mesh (the sharded route: one proof on three
   routes);
16. the entry points: `python -m nova_tpu_torch.bench` with
   NOVA_BENCH_FAST=1 in a subprocess (its last line has bench.py's keys,
   backend "cuda (msm3m)" and a value above 0, and its stage's build_info
   says built False: the kernel library found, not rebuilt), MinRoot's
   advice computed meanwhile; in-process, the bench twin's
   bench_msm("msm1") at 2^16 on the b"bench-msm" key (equal to the native
   host MSM), then one K1, K2 and K3 call of such an MSM at each shape it
   launches against its plain version (bitwise); the MinRoot example's
   twin at 2^15 iterations a step (a primary padded to 2^17, phase 5's
   key) x 3 steps, handed that advice: both verifies pass,
   z_n is the advice's last iterate, a proof with zn changed fails, and
   the largest K1, K5 and B6 call of the replayed step and of the
   compression equal their plain versions (bitwise) and are timed at their
   shapes; the counts reset just before each part and read just after;
   each part's wall seconds;
8. the field microbenchmark (perf/ubench_field.py's lines, N = 2^18,
   ITERS = 20) with the counts reset just before and read just after; P1
   and P2 (one kernel, two limb layouts) against their plain versions
   (bitwise) and timed beside their bound: one Montgomery product per
   column and step.

Phases run in the order 1-7, 9-16, 8; each header line gives the
seconds since the start. After them, launches are checked: K3
(a key's window precompute only) must not launch in a commit, a replayed
prove_step (either curve cycle, or the SHA-256 circuit's), an msm_device2
or a compression, and must
launch once a window in each key's precompute
(16 for the commit key, 19 for the witness key); a commit must launch K2
twice, K5 once and K2s once.

The last lines are the card's name and power limit, one JSON object
{"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# Montgomery product on 8 x 32-bit words: 64 + 64 word products (a*b, m*p),
# each two int32 multiply-adds (low and high halves), plus 8 for m = t*n0.
MUL_OPS = 2 * (64 + 64) + 8
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (NVIDIA H100
# architecture white paper); 3.35 TB/s HBM3 (NVIDIA data sheet).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
ROW = 64  # bytes of one (16,) int32 limb row
SEED = 20260
# sizes of a card run (--rehearse runs 2^10 / 2^14 on the CPU): the msm3m
# commit, and the fold step's primary, the smallest reference bench size
# at which its device routes engage
LOG_N, REHEARSE_LOG_N = 16, 10
FOLD_LOG_CONS, REHEARSE_FOLD_LOG_CONS = 17, 14

REPLACES = {
    "mont_mul": "nova_tpu/fields/pallas_kernels.py:85",
    "xyzz_add": "nova_tpu/fields/pallas_kernels.py:337",
    "xyzz_double": "nova_tpu/fields/pallas_kernels.py:360",
    "accum": "nova_tpu/ops/msm3.py:221",
    "bucket_reduce": "nova_tpu/ops/msm2.py:666",
    "suffix_segmented": "nova_tpu/ops/msm3.py:475",
    "stage": "nova_tpu/ops/msm2.py:432",
    "mont16_chain": "perf/ubench_field.py:141",
    "mont8_chain": "perf/ubench_field.py:208",
}
SOURCE = {
    "mont_mul": "nova_tpu_torch/csrc/field_kernels.cu",
    "xyzz_add": "nova_tpu_torch/csrc/field_kernels.cu",
    "xyzz_double": "nova_tpu_torch/csrc/field_kernels.cu",
    "accum": "nova_tpu_torch/csrc/msm_kernels.cu",
    "bucket_reduce": "nova_tpu_torch/csrc/msm_kernels.cu",
    "suffix_segmented": "nova_tpu_torch/csrc/msm_kernels.cu",
    "stage": "nova_tpu_torch/csrc/stage_kernel.cu",
    "mont16_chain": "nova_tpu_torch/csrc/ubench_kernels.cu",
    "mont8_chain": "nova_tpu_torch/csrc/ubench_kernels.cu",
}
# kernels the commit's main path must launch (phase 2; K3 only in the key's
# window precompute), and the fold step's (phase 5: K2 and K2s in verify's
# msm3 commits)
COMMIT_KERNELS = ("mont_mul", "xyzz_add", "xyzz_double", "accum", "suffix_segmented",
                  "bucket_reduce")
FOLD_KERNELS = ("mont_mul", "xyzz_add", "accum", "suffix_segmented", "bucket_reduce",
                "stage")
# and compression's (phase 7: msm_device2 and the device outer sumcheck),
# and the field microbenchmark's (phase 8)
COMPRESS_KERNELS = ("mont_mul", "bucket_reduce", "stage")
# K2 launches a commit must make: the two 2^15-row adds of _bucket_totals
COMMIT_XYZZ_ADDS = 2
UBENCH_KERNELS = ("mont16_chain", "mont8_chain")
# phase 8 sizes: perf/ubench_field.py's defaults (N = 2^18, ITERS = 20)
UB_LOG_N, UB_ITERS, REHEARSE_UB_LOG_N, REHEARSE_UB_ITERS = 18, 20, 10, 2
# constraints of the primary augmented circuit around a trivial step
# circuit (tests/test_ivc.py); the squaring chain adds one per square
AUGMENTED_PRIMARY_CONS = 9818
FOLD_STEPS = 5
# phases 9-10: the test ptau file's power (2^19 G1 powers: phase 10's
# spark key; phase 9 reads its 2^17 key from the same file), the
# prove_steps (the bump, the tape build, one timed replay), and the kernels
# the KZG and ppsnark paths must launch (K3 only in a key's precompute)
PTAU_POWER, REHEARSE_PTAU_POWER = 19, 18
KZG_STEPS = 3
KZG_KERNELS = ("mont_mul", "xyzz_add", "accum", "suffix_segmented", "bucket_reduce", "stage")
# phase 11: DirectSNARK's squaring chain on Pallas (nnz <= 2^17 and
# 2 num_vars <= 2^17, so N = 2^17 and the key is phase 5's 2^17 + 1 one)
DIRECT_SQUARES, REHEARSE_DIRECT_SQUARES, DIRECT_LOG_N = 32700, 500, 17
# phase 12: the SHA-256 message (benches/sha256.py's larger size: a
# ~82k-constraint primary, above DEVICE_THRESHOLD) and its prove_steps;
# phase 13: NeutronNova's prove_steps (the primary padded as phase 5's)
SHA_MSG_BYTES, REHEARSE_SHA_MSG_BYTES, SHA_STEPS = 128, 3, 3
NEUTRON_STEPS = 3
# the kernel calls phases 6 and 9 capture on their path and hold bitwise
PATH_CHECKS = {"mont_mul", "xyzz_double", "bucket_reduce", "accum", "suffix_segmented",
               "xyzz_add/commit", "mont_mul/spmv"}
# Montgomery products per active lane per round of a B6 stage
STAGE_MULS = {"complete": 26, "fast": 14, "fast0": 6}
# phase 15: the mesh's devices (cuda:0 repeated), the kernels a sharded MSM
# and a meshed prove_step must launch, and those of the entry's msm1
MESH_DEVICES = 4
MESH_MSM_KERNELS = ("mont_mul", "xyzz_add", "accum", "suffix_segmented", "bucket_reduce")
ENTRY_KERNELS = ("mont_mul", "xyzz_add", "xyzz_double")
# rows of captured K1-K3 calls that one plain call takes at most (msm1 at
# 2^16 makes combine calls of 20 windows x 2^16 lanes)
PLAIN_ROWS = 1 << 21
# phase 16: MinRoot's iterations a step (3 constraints each: 2^15 pads the
# primary to 2^17, phase 5's key) and steps, the kernels its replayed step
# and compression must launch, and the bench twin's line
MINROOT_ITERS, REHEARSE_MINROOT_ITERS, MINROOT_STEPS = 1 << 15, 8, 3
MINROOT_KERNELS = ("mont_mul", "bucket_reduce", "stage")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_METRIC = "msm_points_per_sec_per_chip_2e16"
BENCH_TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.abspath(__file__))


class PhaseError(RuntimeError):
    pass


_T0 = time.perf_counter()
_MARKS = []  # (phase, seconds since the start) at each phase header


def log(msg: str) -> None:
    if msg.startswith("== phase") or msg.startswith("== done"):
        now = time.perf_counter() - _T0
        _MARKS.append((msg[3:].split(":")[0], now))
        msg = f"{msg}  [{now:.1f} s since start]"
    print(msg, flush=True)


def phase_walls() -> dict:
    """Each phase's wall seconds, from its header to the next header."""
    return {a[0]: round(b[1] - a[1], 1) for a, b in zip(_MARKS, _MARKS[1:])}


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


def device_ms(torch, fn, reps: int):
    """Device-busy ms of a call of fn that launches each of its kernels
    (and fills and copies) once, under torch.profiler, after one warm-up
    (None where three profiler windows kept no device event); the host
    clock in a --rehearse run, which has no card."""
    if not torch.cuda.is_available():
        return cuda_ms(torch, fn, reps)
    from nova_tpu_torch.perf.bucket_stage import busy_ms

    # the profiler now and then keeps none of a window's device events
    for _ in range(3):
        ms = busy_ms(torch, fn, reps)["once_ms"]
        if ms:
            return ms
    log("device_ms: the profiler recorded no device time in 3 windows (not measured)")
    return None


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


def _numel(x) -> int:
    if isinstance(x, dict):
        return sum(_numel(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_numel(v) for v in x)
    return x.numel() if hasattr(x, "numel") else 0


def _copy(x):
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    return x.clone() if hasattr(x, "clone") else x


@contextlib.contextmanager
def largest_calls(targets: dict):
    """While installed, keep a copy of the arguments of the largest call
    (by tensor elements; the latest among equals) of each function in
    `targets` ({name: (module, attribute)}); yields {name: args}. Keyword
    arguments are kept after the positional ones, in the order given (B6's
    `live` is its last parameter)."""
    seen, sizes, saved = {}, {}, []
    for name, (mod, attr) in targets.items():
        real = getattr(mod, attr)
        saved.append((mod, attr, real))

        def wrapper(*a, _name=name, _real=real, **k):
            args = a + tuple(k.values())
            size = _numel(args)
            if size >= sizes.get(_name, -1):
                sizes[_name], seen[_name] = size, _copy(args)
            return _real(*a, **k)

        setattr(mod, attr, wrapper)
    try:
        yield seen
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def shape_key(args) -> tuple:
    """The shapes of a kernel wrapper's arguments after its TField (a
    tensor's, each coordinate's of a point dict) and its integers."""
    return tuple(tuple(a.shape) if hasattr(a, "shape")
                 else tuple(tuple(v.shape) for v in a.values()) if isinstance(a, dict)
                 else a for a in args[1:])


@contextlib.contextmanager
def every_call(targets: dict, one_per_shape: bool = False):
    """While installed, keep a copy of the arguments of every call of each
    function in `targets` ({name: (module, attribute)}), or with
    `one_per_shape` of the latest call at each distinct shape_key; yields
    {name: [args, ...]}, filled in call order when the block ends."""
    seen, saved = {name: {} for name in targets}, []
    for name, (mod, attr) in targets.items():
        real = getattr(mod, attr)
        saved.append((mod, attr, real))

        def wrapper(*a, _name=name, _real=real):
            key = shape_key(a) if one_per_shape else len(seen[_name])
            seen[_name].pop(key, None)  # the latest call of a shape comes last
            seen[_name][key] = _copy(a)
            return _real(*a)

        setattr(mod, attr, wrapper)
    try:
        yield seen
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
        for name in seen:
            seen[name] = list(seen[name].values())


def kernel_vs_plain(torch, name: str, args) -> int:
    """Kernel `name` and its plain PyTorch version on captured arguments:
    the largest difference over limbs (and flags)."""
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.ops import msm2, msm3

    tf = args[0]
    o = tf.ops(first_input(args).device)

    def limbs(P):
        return tuple(P[k].long() for k in fk.KEYS)

    if name == "mont_mul":
        _, a, b = args
        got = fk.mont_mul(tf, a, b)
        ref = o.mul(a.long(), b.long()).expand(got.shape)
        return int((got.long() - ref).abs().max().item())
    if name == "xyzz_add":
        _, P, Q = args
        ref = fk.xyzz_add_limbs(o, limbs(P), limbs(Q))
        return max_abs_err(torch, fk.xyzz_add(tf, P, Q), dict(zip(fk.KEYS, ref)))
    if name == "xyzz_double":
        _, P, *times = args  # times: 1 unless given
        ref = fk.xyzz_double_limbs(o, limbs(P), *times)
        return max_abs_err(torch, fk.xyzz_double(tf, P, *times), dict(zip(fk.KEYS, ref)))
    if name == "bucket_reduce":
        _, table = args[:2]
        return max_abs_err(torch, msm2._bucket_reduce(tf, table),
                           msm2.bucket_reduce_plain(tf, table))
    if name == "suffix_segmented":
        return max_abs_err(torch, msm3.suffix_to_buckets(*args),
                           msm3.suffix_to_buckets_plain(*args))
    if name == "accum":
        got, ref = msm3.accum(*args), msm3.accum_plain(*args)
        return max(max_abs_err(torch, got[0], ref[0]), max_abs_err(torch, got[1], ref[1]),
                   int((got[2] - ref[2]).abs().max().item()))
    if name == "stage":
        # (tf, rounds, masks, pts, mode, live); a flag that differs counts 1;
        # the plain version in blocks of PLAIN_ROWS lanes (the same values)
        (got, gflag), (ref, rflag) = (msm2.stage(*args),
                                      msm2.stage_plain(*args, block=PLAIN_ROWS))
        return max(max_abs_err(torch, got, ref), int(bool(gflag.any()) != bool(rflag)))
    raise ValueError(name)


def calls_vs_plain(torch, name: str, calls) -> int:
    """Kernel `name` (K1, K2, K3 or K5) launched at each captured call's
    own shapes against its plain version run over the rows of many calls
    stacked (by field, and by doubling count for K3; the plain versions
    are row-wise), at most PLAIN_ROWS rows or one call at a time; K5's
    plain version over the tables of one size as a batch: the largest
    difference over limbs."""
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.ops import msm2

    err, groups = 0, {}
    if name == "bucket_reduce":
        for a in calls:
            groups.setdefault((a[0].spec.p, a[1]["x"].shape), []).append(a)
        for cs in groups.values():
            tf = cs[0][0]
            ref = msm2.bucket_reduce_plain(
                tf, {k: torch.stack([a[1][k] for a in cs]) for k in fk.KEYS})
            for i, a in enumerate(cs):
                err = max(err, max_abs_err(torch, msm2._bucket_reduce(tf, a[1]),
                                           {k: ref[k][i] for k in fk.KEYS}))
        return err
    keys = ("x",) if name == "mont_mul" else fk.KEYS

    def flush(key):
        tf, rows = groups.pop(key)
        ins = [tuple(torch.cat([r[i][k] for r in rows]).long() for k in keys)
               for i in range(len(rows[0]))]
        got = dict(zip(keys, ins.pop()))
        o = tf.ops(got["x"].device)
        if name == "mont_mul":
            return int((got["x"] - o.mul(ins[0][0], ins[1][0])).abs().max().item())
        ref = (fk.xyzz_add_limbs(o, *ins) if name == "xyzz_add"
               else fk.xyzz_double_limbs(o, ins[0], *key[1]))
        return max_abs_err(torch, got, dict(zip(fk.KEYS, ref)))

    for a in calls:
        tf = a[0]
        if name == "mont_mul":
            # the operands broadcast to the call's shape, as one-key dicts
            ops = [{"x": t} for t in a[1:]]
            got, times = {"x": fk.mont_mul(tf, a[1], a[2])}, ()
        else:
            ops = [P for P in a[1:] if isinstance(P, dict)]
            times = tuple(x for x in a[2:] if isinstance(x, int))
            got = (fk.xyzz_add(tf, *ops) if name == "xyzz_add"
                   else fk.xyzz_double(tf, ops[0], *times))
        shape = torch.broadcast_shapes(*(P[k].shape for P in ops for k in keys))
        row = [{k: P[k].expand(shape).reshape(-1, 16) for k in keys} for P in ops + [got]]
        key = (tf.spec.p, times)
        rows = groups.setdefault(key, (tf, []))[1]
        rows.append(row)
        if sum(r[0]["x"].shape[0] for r in rows) >= PLAIN_ROWS:
            err = max(err, flush(key))
    for key in list(groups):
        err = max(err, flush(key))
    return err


def first_input(args):
    """The first tensor argument of a kernel wrapper (after its TField): a
    limb tensor, a digit sequence, or the x coordinates of a point dict."""
    for a in args[1:]:
        if isinstance(a, dict):
            return a["x"]
        if hasattr(a, "device"):
            return a


def profile_window(torch, fn, reps: int, what: str) -> None:
    """torch.profiler over `reps` calls of fn (after one warm-up call):
    device-busy share of the wall time and the kernels that take the
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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
    log(f"profile: {reps} {what}, wall {wall_us / reps / 1e3:.3f} ms each, "
        f"device busy {busy / reps / 1e3:.3f} ms each "
        f"({100 * busy / wall_us:.1f}% of wall)")
    for dev_us, count, key in rows[:15]:
        log(f"profile:   {dev_us / reps / 1e3:8.3f} ms each  "
            f"{count // reps:5d} calls  {key[:90]}")


def square_chain(num_squares: int):
    """benches/recursive_snark.py's step circuit: y <- y^2, num_squares
    times, one constraint and one variable per square."""
    from nova_tpu_torch.nova.circuit import StepCircuit

    class SquareChain(StepCircuit):
        def arity(self):
            return 1

        def synthesize(self, cs, z):
            y = z[0]
            for _ in range(num_squares):
                y = y.square(cs)
            return [y]

    return SquareChain()


def stage_bound(masks, mode: str, affine: bool):
    """B6's least time on this run's inputs: each input read once (2 or 4
    coordinates, the masks, the live flags) and 4 coordinates written, or
    the multiply-adds of the adds that this run's masks make active."""
    rounds, n = masks.shape
    nbytes = n * ((2 if affine else 4) * ROW + 4 * rounds + (4 if affine else 0) + 4 * ROW)
    active = masks.ne(0).sum(dim=1).tolist()
    muls = [STAGE_MULS["fast0"] if mode == "fast0" and r == 0
            else STAGE_MULS["fast" if mode == "fast0" else mode]
            for r in range(rounds)]
    return bound(nbytes, MUL_OPS * sum(a * m for a, m in zip(active, muls)))


def accum_bound(sorted_d, R: int, C: int, tails):
    """K4's least time on this run's inputs, whatever implements it: a base
    row (x and y, 128 B) and a sign read for each live (nonzero-digit)
    cell, the digit (4 B) and the sort index (8 B) read once per cell, the
    tail rows that this run writes and the C carries (4 coordinates) and
    flags written once; or the 10 products of each mixed add, one per live
    cell whose digit repeats the one above it in its column."""
    cells = sorted_d.view(C, R)
    live = int(cells.ne(0).sum())
    repeat = int(((cells[:, 1:] == cells[:, :-1]) & (cells[:, 1:] != 0)).sum())
    written = int(tails["zz"].ne(0).any(-1).sum()) + C
    nbytes = live * (2 * ROW + 4) + R * C * (4 + 8) + written * 4 * ROW + 4 * C
    return bound(nbytes, MUL_OPS * 10 * repeat)


def bucket_reduce_bound(nb: int):
    """K5's least time, whatever implements it: the (nb, 16) table read
    once and one row written, or the 2 (nb - 1) complete adds (14 products
    each) that sum_i (i+1) T_i needs."""
    return bound(4 * ROW * (nb + 1), MUL_OPS * 14 * 2 * (nb - 1))


def suffix_bound(torch, digs, nb: int):
    """K2s's least time on this run's inputs: the digits and carries read
    once and the run totals written; or the complete adds the runs need
    (one per carry whose digit repeats the next one's)."""
    d = digs.long()
    repeat = int((d[1:] == d[:-1]).sum())
    runs = torch.unique_consecutive(d)
    written = int(((runs >= 1) & (runs <= nb)).sum())
    return bound(d.numel() * (4 + 4 * ROW) + written * 4 * ROW, MUL_OPS * 14 * repeat)


def double_bound(P: dict, times: int):
    """K3's least time for `times` chained doublings of these rows: 8 rows
    of 64 B moved per lane once for the whole chain, or 9 products per
    doubling of each live lane (a point of a prime-order group does not
    reach the identity by doubling, so each live lane of a key's bases
    needs all of them)."""
    rows = P["zz"].shape[0]
    live = int(P["zz"].ne(0).any(-1).sum())
    return bound(8 * ROW * rows, MUL_OPS * 9 * times * live)


def add_bound(P: dict, Q: dict, rows: int):
    """K2's least time on these rows: 12 rows of 64 B moved per lane, or
    14 products per lane whose operands are both live."""
    live = int((P["zz"].ne(0).any(-1) & Q["zz"].ne(0).any(-1)).sum())
    return bound(12 * ROW * rows, MUL_OPS * 14 * live)


def precompute_ms(torch, fn) -> dict:
    """A key's window precompute (fn): wall ms of one call on the host
    clock up to a synchronise, and its device-busy ms under torch.profiler
    (one call after a warm-up)."""
    from nova_tpu_torch.perf.bucket_stage import busy_ms

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = busy_ms(torch, fn, 1)
    return {"wall_ms": wall, "busy_ms": prof["busy_ms"],
            "profiled_wall_ms": prof["wall_ms"]}


def launch_delta(_build, before: dict) -> dict:
    """Launches of each kernel since the snapshot `before`."""
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()}


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def recorded_stages(fn):
    """fn() with the arguments of every B6 call recorded: (result, [(args,
    kwargs), ...])."""
    from nova_tpu_torch.ops import msm2

    captured = []
    real_stage = msm2.stage

    def recording_stage(*a, **k):
        captured.append((a, k))
        return real_stage(*a, **k)

    msm2.stage = recording_stage
    try:
        return fn(), captured
    finally:
        msm2.stage = real_stage


def stage_modes(torch, captured, reps: int, timed: bool):
    """B6 against its plain version on the first stage (affine input) and
    the second (XYZZ input) recorded from one msm_device2, in every mode
    each runs (fast0 and complete; fast and complete), bitwise with equal
    flags; timed beside its bound when `timed`. Returns (rows by stage and
    mode, the largest difference, the first stage's fast0 arguments)."""
    from nova_tpu_torch.ops import msm2

    (tf, rounds, masks, pts, _), k0 = captured[0][0], captured[0][1]
    first = (tf, rounds, masks, pts, k0.get("live"))
    (tf, rounds, masks, pts, _), _k = captured[1][0], captured[1][1]
    later = (tf, rounds, masks, pts, None)
    stage_rows, err = {}, 0
    for label, mode, (tf, rounds, masks, pts, live) in (
        ("first", "fast0", first), ("first", "complete", first),
        ("later", "fast", later), ("later", "complete", later),
    ):
        got, gflag = msm2.stage(tf, rounds, masks, pts, mode, live)
        ref, rflag = msm2.stage_plain(tf, rounds, masks, pts, mode, live)
        e = max_abs_err(torch, got, ref)
        if bool(gflag.any()) != bool(rflag):
            raise PhaseError(f"B6 {mode} on the {label} stage: flag {gflag} != {rflag}")
        err = max(err, e)
        row = {"lanes": int(masks.shape[1]), "rounds": rounds, "max_abs_err": e}
        if timed:
            b_ms, b_by = stage_bound(masks, mode, live is not None)
            row.update({
                "ms": cuda_ms(torch, lambda: msm2.stage(tf, rounds, masks, pts, mode, live),
                              reps),
                "plain_ms": cuda_ms(
                    torch, lambda: msm2.stage_plain(tf, rounds, masks, pts, mode, live), 1),
                "bound_ms": b_ms, "bound_by": b_by,
            })
        stage_rows[f"{label}/{mode}"] = row
    log("B6: " + json.dumps(stage_rows))
    if err:
        raise PhaseError(f"B6 disagrees with its plain version: max |err| {err}")
    return stage_rows, err, first[:4] + ("fast0", first[4])


def precompute_kernels(scalars, db, want):
    """msm_device2 of `scalars` on a fresh copy of the bases `db`, so the
    window precompute is rebuilt, with the largest calls of K1, K2, K3 and
    K5 recorded; the result must equal `want`. Returns (the recorded
    calls, the fresh bases, the launches of an msm_device2 without the
    precompute, the precompute's own launches)."""
    from nova_tpu_torch import _build
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.ops import msm2

    fresh = msm2.DeviceBases2.from_tensors(db.curve, db.x, db.y, db.inf)
    before = dict(_build.LAUNCHES)
    with largest_calls({"mont_mul": (fk, "mont_mul"), "xyzz_add": (fk, "xyzz_add"),
                        "xyzz_double": (fk, "xyzz_double"),
                        "bucket_reduce": (msm2, "_bucket_reduce")}) as seen:
        again = msm2.msm_device2(scalars, device_bases=fresh, reuse=True)
    if again != want:
        raise PhaseError(f"msm_device2 with the precompute rebuilt: {again} != {want}")
    cold = launch_delta(_build, before)
    before = dict(_build.LAUNCHES)
    msm2.msm_device2(scalars, device_bases=fresh, reuse=True)
    warm = launch_delta(_build, before)
    precompute = {k: cold[k] - warm[k] for k in cold}
    log(f"msm_device2 launches: with the window precompute {cold}, without {warm}; "
        f"the precompute alone {precompute}")
    return seen, fresh, warm, precompute


def path_kernels(args, torch, dev, pp, rs, workers: int, reps: int, timed: bool) -> dict:
    """The checks of a fold step's kernels on its own inputs (phases 6 and
    9), on the primary's curve: one fresh primary witness committed by
    msm_device2, msm_device3 and the host Pippenger (equal); B6 against its
    plain version on the stage inputs of that commit, in every mode that
    stage runs (timed when `timed`); K1, K3 and K5 in msm_device2 on a
    fresh copy of the witness key (the window precompute rebuilt); K4, K2s
    and K2 in a commit of the running witness; the device cross-term
    commit_T_device (plain and relaxed) on the padded primary against T
    formed on the host, with K1 in its SpMV; every kernel bitwise."""
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops import fold as fold_ops
    from nova_tpu_torch.ops import msm2, msm3, spmv
    from nova_tpu_torch.ops.fvec import FVec, as_list
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    curve = pp.ck_primary.curve
    witness = list(rs._wgen_primary.cs.aux_assignment)
    if args.rehearse:
        witness = witness[:512]
    n = len(witness)
    db = pp.ck_primary.device_bases2(n)
    got2, captured = recorded_stages(lambda: msm2.msm_device2(witness, device_bases=db,
                                                              reuse=True))
    got3 = msm3.msm_device3(witness, device_bases=db)
    host = host_msm_parallel(curve, witness, pp.ck_primary.ck[:n], workers)
    if not got2 == got3 == host:
        raise PhaseError(f"fresh witness: msm_device2 {got2}, msm_device3 {got3}, host {host}")
    log(f"fresh {curve.name} witness ({n} scalars): msm_device2 == msm_device3 == host msm")
    stage_rows, err, first = stage_modes(torch, captured, reps, timed)

    # K1, K3-K5 and K2s against their plain versions on the inputs the fold
    # step gives them: an msm_device2 on a fresh copy of the witness key
    # recomputes the window precompute (K3 doublings, K1 in the batched
    # inversion) and reduces its buckets (K5); a commit of the running
    # witness (verify's route) runs K4, K2s and K2; the cross-term's SpMV
    # runs K1
    seen, fresh, warm, precompute = precompute_kernels(witness, db, got2)
    sf = TField(curve.scalar)
    with largest_calls({"accum": (msm3, "accum"),
                        "suffix_segmented": (msm3, "suffix_to_buckets"),
                        "xyzz_add/commit": (fk, "xyzz_add")}) as seen4:
        CommitmentEngine.commit(pp.ck_primary, FVec.coerce(sf, rs.r_W_primary.W, dev))
    seen.update(seen4)

    # the device cross-term on the padded (square) primary shape, plain and
    # relaxed (the running instance folded with itself), against T formed
    # on the host with pure-Python SpMV
    S = pp.r1cs_shape_primary.pad()
    U, Wr = rs.r_U_primary, rs.r_W_primary.pad(S)
    with largest_calls({"spmv": (spmv, "spmv_m")}) as seen_spmv:
        t_dev = {rel: fold_ops.commit_T_device(S, U, Wr, U, Wr, rel, dev).to_ints()
                 for rel in (False, True)}
    q = S.field.p
    ww, ew = as_list(Wr.W), as_list(Wr.E)
    for rel in (False, True):
        u = (U.u + (U.u if rel else 1)) % q
        z = [2 * w % q for w in ww] + [u] + [2 * x % q for x in U.X]
        az, bz, cz = (M.multiply_vec(z) for M in (S.A, S.B, S.C))
        e = 2 if rel else 1
        if t_dev[rel] != [(a * b - u * c - e * x) % q for a, b, c, x in zip(az, bz, cz, ew)]:
            raise PhaseError(f"commit_T_device (relaxed={rel}) != host T")
    t_ms = None
    if timed:
        t_ms = cuda_ms(torch, lambda: fold_ops.commit_T_device(S, U, Wr, U, Wr, True, dev),
                       reps)
    log(f"commit_T_device on the {S.num_cons} x {S.num_vars} padded primary: plain and "
        f"relaxed == host T; relaxed {t_ms} ms")
    tf_s, csr, zm = seen_spmv["spmv"]
    seen["mont_mul/spmv"] = (tf_s, zm[csr.indices], csr.data)

    # (a rehearsal's 2^14 running witness is committed on the host: no K4,
    # K2s or commit K2 there)
    missing = PATH_CHECKS - set(seen)
    if missing and not args.rehearse:
        raise PhaseError(f"kernel calls not seen on the fold step's path: {sorted(missing)}")
    kernel_errs, checked = {}, {}
    for label, a in seen.items():
        name = label.split("/")[0]
        e = kernel_vs_plain(torch, name, a)
        kernel_errs[name] = max(kernel_errs.get(name, 0), e)
        checked[label] = {"rows": list(first_input(a).shape), "max_abs_err": e}
    kernel_errs["stage"] = err
    log(f"{curve.name} fold-step kernels against their plain versions: " + json.dumps(checked))
    bad = {k: e for k, e in kernel_errs.items() if e}
    if bad:
        raise PhaseError(f"fold-step kernels disagree with their plain versions: {bad}")
    return {"witness": witness, "db": db, "got2": got2, "fresh": fresh, "stage_rows": stage_rows,
            "stage_err": err, "stage_first": first,
            "seen": seen, "kernel_errs": kernel_errs, "warm": warm,
            "precompute": precompute, "commit_T_ms": t_ms}


def _profile(on: bool) -> None:
    """Turn the prover's phase totals (nova_tpu_torch.profiling) on or off."""
    from nova_tpu_torch import profiling

    profiling.enable(on)


def drive_steps(torch, pp, circuit, steps: int, squares: int, modulus: int) -> dict:
    """RecursiveSNARK.new on z0 = [2], `steps` prove_steps (each timed, by
    phase too, with its launches), then verify, which must return
    z0^(2^(squares * steps)) mod `modulus`. The counts are reset just
    before new; the phase totals must be on (_profile(True))."""
    from nova_tpu_torch import _build, profiling
    from nova_tpu_torch.nova.ivc import RecursiveSNARK

    z0 = [2]
    _build.reset_launches()
    t0 = time.perf_counter()
    rs = RecursiveSNARK.new(pp, circuit, z0)
    sync(torch)
    new_s = time.perf_counter() - t0
    step_s, step_launches, step_phases = [], [], []
    for _ in range(steps):
        before = dict(_build.LAUNCHES)
        profiling.global_reset()
        t0 = time.perf_counter()
        rs.prove_step(pp, circuit)
        sync(torch)
        step_s.append(time.perf_counter() - t0)
        step_launches.append(launch_delta(_build, before))
        step_phases.append({k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()})
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    out = rs.verify(pp, steps, z0)
    sync(torch)
    verify_s = time.perf_counter() - t0
    want = pow(z0[0], pow(2, squares * steps, modulus - 1), modulus)
    if out != [want]:
        raise PhaseError(f"verify returned {out}, expected [{want}]")
    log(f"new {new_s:.2f} s; prove_step s {[round(t, 3) for t in step_s]}; verify "
        f"{verify_s:.2f} s == z0^(2^({squares} * {steps})) mod p")
    return {"rs": rs, "z0": z0, "new_s": new_s, "step_s": step_s,
            "step_launches": step_launches, "step_phases": step_phases,
            "verify_s": verify_s, "verify_launches": launch_delta(_build, before)}


def fold_step(args, torch, dev, workers: int, msm_ck, msm_scal) -> dict:
    """Phases 5 and 6: the fold step's main path, then its checks and
    timings. Returns the stage kernel's row fields and the fold-step
    numbers."""
    import numpy as np

    from nova_tpu_torch import _build, native
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    reps = 1 if args.rehearse else 5
    log_cons = REHEARSE_FOLD_LOG_CONS if args.rehearse else FOLD_LOG_CONS
    log(f"== phase 5: fold step (squaring chain, primary 2^{log_cons} "
        f"constraints, {FOLD_STEPS} prove_steps)")
    # the fold step's host routes (secondary commits, cross-terms, Poseidon,
    # satisfiability checks) run in the native binding, as in the reference
    if not native.available():
        raise PhaseError("the native host binding did not build (native/nova_native.cpp)")
    squares = (1 << log_cons) - AUGMENTED_PRIMARY_CONS
    circuit = square_chain(squares)
    t0 = time.perf_counter()
    pp = PublicParams.setup(PallasEngine, VestaEngine, circuit, device=dev)
    setup_s = time.perf_counter() - t0
    log(f"setup: constraints {pp.num_constraints()}, variables {pp.num_variables()}, "
        f"keys {len(pp.ck_primary)}/{len(pp.ck_secondary)} on {pp.ck_primary.device}, "
        f"{setup_s:.1f} s")
    if pp.num_constraints()[0] != 1 << log_cons:
        raise PhaseError(f"primary has {pp.num_constraints()[0]} constraints")

    _profile(True)
    run = drive_steps(torch, pp, circuit, FOLD_STEPS, squares, pallas.scalar.p)
    _profile(False)
    rs, new_s, step_s = run["rs"], run["new_s"], run["step_s"]
    step_launches, step_phases = run["step_launches"], run["step_phases"]
    verify_s, verify_launches = run["verify_s"], run["verify_launches"]
    launches = dict(_build.LAUNCHES)
    step_stage = [sl["stage"] for sl in step_launches]
    log(f"fold-step launches {launches}; B6 launches per prove_step {step_stage}")
    if args.profile:
        profile_window(torch, lambda: rs.prove_step(pp, circuit), 2, "prove_steps")
    if not args.rehearse:
        missing = [k for k in FOLD_KERNELS if launches[k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the fold step: {missing}")
        if any(c == 0 for c in step_stage[1:]):
            raise PhaseError(f"a folding prove_step launched no B6: {step_stage}")
    replay = step_phases[2:]
    phases = {k: statistics.median(ph.get(k, 0.0) for ph in replay) for k in replay[0]}
    fold = {
        "primary_constraints": pp.num_constraints()[0],
        "primary_variables": pp.num_variables()[0],
        "secondary_constraints": pp.num_constraints()[1],
        "setup_s": setup_s, "new_s": new_s,
        "prove_step_ms": statistics.median(step_s[2:]) * 1e3,
        "prove_step_all_ms": [s * 1e3 for s in step_s],
        "phase_ms": phases, "verify_ms": verify_s * 1e3,
        "stage_launches_per_step": step_stage, "launches": launches,
        # per call: each replayed step (steps 3-5; step 1 only bumps the
        # counter, step 2 builds the tape) and verify
        "launches_per_replayed_step": step_launches[2:], "verify_launches": verify_launches,
    }
    log("fold step: " + json.dumps(fold))

    log("== phase 6: fold-step kernels and MSMs")
    t6 = time.perf_counter()
    chk = path_kernels(args, torch, dev, pp, rs, workers, reps, timed=True)
    witness, db, got2, fresh = chk["witness"], chk["db"], chk["got2"], chk["fresh"]
    stage_rows, err, seen, kernel_errs = (chk["stage_rows"], chk["stage_err"], chk["seen"],
                                          chk["kernel_errs"])
    warm, precompute, t_ms = chk["warm"], chk["precompute"], chk["commit_T_ms"]
    # K5 on msm_device2's table (2^13 buckets at the 2^17 witness)
    tf5, table5 = seen["bucket_reduce"][:2]
    k5_d2 = {"buckets": int(table5["x"].shape[0]),
             "ms": cuda_ms(torch, lambda: msm2._bucket_reduce(tf5, table5), reps),
             "plain_ms": cuda_ms(torch, lambda: msm2.bucket_reduce_plain(tf5, table5), 1),
             "bound": bucket_reduce_bound(table5["x"].shape[0])}
    log("K5 on msm_device2's table: " + json.dumps(k5_d2))
    # K3 on the witness key's last window (c chained doublings of its rows,
    # the precompute's own input) and the key's whole window precompute,
    # wall and device-busy. The window is timed by CUDA events around 8
    # launches back to back (each takes longer on the card than its host
    # enqueue, so the events see the device's time): torch.profiler kept
    # no device event of this call here in two card runs.
    tfw, pw, times = seen["xyzz_double"]
    rows_w = int(pw["x"].shape[0])
    k3_window = {f"{rows_w} rows x {times}, events over 8 launches": (
        cuda_ms(torch, lambda: [fk.xyzz_double(tfw, pw, times) for _ in range(8)], reps) / 8,
        double_bound(pw, times))}
    precompute_t = {}
    if not args.rehearse:
        bx, by, binf = msm2._sized(fresh, rows_w)
        Ww = msm2._num_windows2(times)
        precompute_t = precompute_ms(
            torch, lambda: msm2._precompute_shifted(tfw, times, Ww, bx, by, binf))
    log(f"K3 at the witness key's window (ms, (bound ms, by)): {json.dumps(k3_window)}; "
        f"the witness key's window precompute: {json.dumps(precompute_t)}")

    # msm_device2 at the witness size and on the msm3m key and scalars
    msm2_t = {}
    for label, scal, dbs in (("witness", witness, db),
                             ("msm3m", msm_scal, msm_ck.device_bases2(len(msm_scal)))):
        msm2.msm_device2(scal, device_bases=dbs, reuse=True)
        ts = []
        for _ in range(3 if not args.rehearse else 1):
            t0 = time.perf_counter()
            msm2.msm_device2(scal, device_bases=dbs, reuse=True)
            ts.append(time.perf_counter() - t0)
        msm2_t[label] = {"n": len(scal), "ms": statistics.median(ts) * 1e3,
                         "pts_per_s": len(scal) / statistics.median(ts)}
    log("msm_device2: " + json.dumps(msm2_t))

    # repeated bases: the fast pass flags P = +-Q and the complete rerun runs
    rep = (pp.ck_primary.ck[:8] * 512)[:4096]
    small = [int(x) for x in np.random.default_rng(SEED + 1).integers(0, 1 << 16, len(rep))]
    db_rep = msm2.DeviceBases2(pallas, rep, device=dev)
    before = _build.LAUNCHES["stage"]
    got = msm2.msm_device2(small, device_bases=db_rep, reuse=True)
    passes = _build.LAUNCHES["stage"] - before
    c_rep = msm2._window_for(4096)
    per_pass = len(msm2._plan(msm2._num_windows2(c_rep) * 4096, 1 << (c_rep - 1)))
    if got != host_msm_parallel(pallas, small, rep, workers):
        raise PhaseError("repeated-base msm_device2 != host msm")
    log(f"repeated bases: equal to the host msm; B6 launches {passes} "
        f"(expected {2 * per_pass}: fast pass + complete rerun)")
    if not args.rehearse and passes != 2 * per_pass:
        raise PhaseError("repeated bases did not take the complete rerun")
    log(f"phase 6: {time.perf_counter() - t6:.1f} s")

    main = stage_rows["first/fast0"]
    return {
        "row": {"launches": launches["stage"], "max_abs_err": err, "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"]},
        "fold": fold, "stage_modes": stage_rows, "msm_device2": msm2_t,
        "fold_launches": launches, "kernel_errs": kernel_errs, "commit_T_ms": t_ms,
        "k5_msm_device2": k5_d2,
        "msm_device2_launches": warm, "witness_precompute_launches": precompute,
        "k3_window": k3_window, "witness_precompute_ms": precompute_t,
        "witness_window": times,
        "pp": pp, "rs": rs, "circuit": circuit, "squares": squares,
    }


def tampered_fail(verify, changes) -> None:
    """Each change (what, apply, undo) applied alone must make verify()
    raise NovaError; every change is undone after its try."""
    from nova_tpu_torch.errors import NovaError

    for what, apply, undo in changes:
        apply()
        try:
            verify()
        except NovaError:
            pass
        else:
            raise PhaseError(f"a proof with {what} changed verified")
        finally:
            undo()
    log(f"tampered proofs ({', '.join(c[0] for c in changes)}) fail to verify")


@contextlib.contextmanager
def outer_sumchecks(torch):
    """While installed, record the largest outer sumcheck (by rounds; the
    latest among equals), whichever route proves it: its route, inputs, a
    copy of its transcript, its result and its wall ms. Yields the record."""
    import copy

    from nova_tpu_torch.ops import sumcheck as dsc
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    outer = {}
    real_dev = dsc.prove_cubic_with_three_inputs_device
    real_host = SumcheckProof.prove_cubic_with_three_inputs

    def keep(route, field, claim, taus, tables, transcript, run):
        tcopy = copy.deepcopy(transcript, {id(transcript.scalar_field): transcript.scalar_field})
        t0 = time.perf_counter()
        res = run()
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        if len(taus) >= outer.get("rounds", -1):
            outer.update(route=route, rounds=len(taus), field=field, claim=claim,
                         taus=list(taus), tables=tables, transcript=tcopy, result=res,
                         ms=ms)
        return res

    def on_device(field, claim, taus, Az, Bz, Cz, transcript, device=None):
        return keep("device", field, claim, taus, (Az, Bz, Cz), transcript,
                    lambda: real_dev(field, claim, taus, Az, Bz, Cz, transcript, device=device))

    def on_host(field, claim, taus, A, B, C, transcript):
        tables = tuple(list(pl.Z) for pl in (A, B, C))
        return keep("host", field, claim, taus, tables, transcript,
                    lambda: real_host(field, claim, taus, A, B, C, transcript))

    dsc.prove_cubic_with_three_inputs_device = on_device
    SumcheckProof.prove_cubic_with_three_inputs = staticmethod(on_host)
    try:
        yield outer
    finally:
        dsc.prove_cubic_with_three_inputs_device = real_dev
        SumcheckProof.prove_cubic_with_three_inputs = staticmethod(real_host)


def other_route(torch, dev, o: dict, mesh=None) -> float:
    """The outer sumcheck recorded by outer_sumchecks again, on the same
    tables and a copy of its transcript, through the other route (on the
    card: the host native loop; in a rehearsal, which proves on the host,
    the device route) and, with a `mesh`, through the sharded prover on it;
    fails unless every route gives the same proof byte for byte. Returns
    the other route's wall ms, or {"other_ms", "sharded_ms"} with a mesh."""
    import copy

    from nova_tpu_torch.ops import sumcheck as dsc
    from nova_tpu_torch.parallel import prove_cubic_with_three_inputs_sharded
    from nova_tpu_torch.spartan.polys import MultilinearPolynomial as ML
    from nova_tpu_torch.spartan.sumcheck import SumcheckProof

    field, tables, tr = o["field"], o["tables"], o["transcript"]

    def fresh():
        return copy.deepcopy(tr, {id(tr.scalar_field): tr.scalar_field})

    def proof(res):
        return [cp.coeffs_except_linear_term for cp in res[0].compressed_polys], res[1], res[2]

    routes = {"other": lambda: (
        SumcheckProof.prove_cubic_with_three_inputs(
            field, o["claim"], o["taus"], *(ML(field, t) for t in tables), fresh())
        if o["route"] == "device" else dsc.prove_cubic_with_three_inputs_device(
            field, o["claim"], o["taus"], *tables, fresh(), device=dev))}
    if mesh is not None:
        routes["sharded"] = lambda: prove_cubic_with_three_inputs_sharded(
            field, o["claim"], o["taus"], *tables, fresh(), mesh)
    ms = {}
    for name, run in routes.items():
        t0 = time.perf_counter()
        res = run()
        sync(torch)
        ms[name] = (time.perf_counter() - t0) * 1e3
        if proof(res) != proof(o["result"]):
            raise PhaseError(f"outer sumcheck: the {name} route's proof differs from the "
                             f"{o['route']} route's")
    log(f"outer sumcheck ({o['rounds']} rounds): {o['route']} on the main path "
        f"{o['ms']:.1f} ms; " + "; ".join(
            f"the {name} route{f' on {mesh.size} devices' if name == 'sharded' else ''} "
            f"gives the same proof byte for byte ({t:.1f} ms)" for name, t in ms.items()))
    if mesh is None:
        return ms["other"]
    return {"other_ms": ms["other"], "sharded_ms": ms["sharded"]}


def compress(args, torch, dev, pp, rs) -> dict:
    """Phase 7: CompressedSNARK setup -> prove -> verify on the fold step's
    RecursiveSNARK (counts reset just before setup, read just after
    verify), then its checks: a tampered proof fails, the outer sumcheck
    again on the same tables through the other route (the host native loop
    on the card) and the sharded route on phase 15's mesh, K1 in the device outer sumcheck's first round against its
    plain version, and the randomizer's W commit against the native host
    MSM."""
    from nova_tpu_torch import _build, native, profiling
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.ops import sumcheck as dsc

    S = pp.r1cs_shape_primary
    log(f"== phase 7: compression (CompressedSNARK on the {S.num_cons}-constraint "
        f"primary after {rs.i} steps)")
    if not native.available():
        raise PhaseError("the native host binding did not build (native/nova_native.cpp)")

    # recorded while installed: the largest outer sumcheck (the primary's),
    # whichever route proves it (outer_sumchecks); K1's arguments in the
    # first device round; the primary's random pair
    k1, pair = {}, {}
    real_round = dsc.DeviceSumcheck.cubic_eq_round
    real_sample = S.sample_random_instance_witness

    def first_round(self, *polys):
        if k1:
            return real_round(self, *polys)
        with largest_calls({"mont_mul": (fk, "mont_mul")}) as seen:
            out = real_round(self, *polys)
        k1.update(seen)
        return out

    def sample(ck):
        pair["U"], pair["W"] = real_sample(ck)
        return pair["U"], pair["W"]

    z0 = [2]
    _profile(True)
    dsc.DeviceSumcheck.cubic_eq_round = first_round
    S.sample_random_instance_witness = sample
    try:
        with outer_sumchecks(torch) as outer:
            _build.reset_launches()
            t0 = time.perf_counter()
            pk, vk = CompressedSNARK.setup(pp)
            setup_s = time.perf_counter() - t0
            profiling.global_reset()
            t0 = time.perf_counter()
            with largest_calls({"bucket_reduce": (msm2, "_bucket_reduce")}) as seen_k5:
                snark = CompressedSNARK.prove(pp, pk, rs)
            sync(torch)
            prove_s = time.perf_counter() - t0
            phases = {k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()}
            t0 = time.perf_counter()
            out = snark.verify(vk, rs.i, z0)
            sync(torch)
            verify_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            _profile(False)
            log(f"setup {setup_s:.2f} s; prove {prove_s:.2f} s; verify {verify_s:.2f} s; "
                f"launches {launches}")
            log("prove phases (ms, both curves): " + json.dumps(phases))
            if out != list(rs.zi):
                raise PhaseError(f"verify returned {out}, expected {rs.zi}")
            if not args.rehearse:
                missing = [k for k in COMPRESS_KERNELS if launches[k] == 0]
                if missing:
                    raise PhaseError(f"kernels not launched on compression: {missing}")
                if outer["route"] != "device":
                    raise PhaseError("the primary's outer sumcheck did not take the device route")

            # a tampered proof fails
            p = S.field.p
            zn, sp = list(snark.zn), snark.snark_primary
            ew = sp.eval_W
            tampered_fail(lambda: snark.verify(vk, rs.i, z0), [
                ("zn", lambda: setattr(snark, "zn", [(z + 1) % p for z in zn]),
                 lambda: setattr(snark, "zn", zn)),
                ("the primary's eval_W", lambda: setattr(sp, "eval_W", (ew + 1) % p),
                 lambda: setattr(sp, "eval_W", ew)),
            ])
        # the outer sumcheck again on the same tables through the other
        # route (in a rehearsal the device route, whose first round K1 is
        # recorded here)
        o = outer
        routes = other_route(torch, dev, o, mesh=mesh_of(dev))
    finally:
        dsc.DeviceSumcheck.cubic_eq_round = real_round
        del S.sample_random_instance_witness
        _profile(False)

    k1_err = kernel_vs_plain(torch, "mont_mul", k1["mont_mul"])
    k1_rows = list(first_input(k1["mont_mul"]).shape)
    log(f"K1 in the first device round ({k1_rows}): max |kernel - plain| {k1_err}")
    if k1_err:
        raise PhaseError(f"K1 disagrees with its plain version in the outer sumcheck: {k1_err}")
    k5_err = 0
    if "bucket_reduce" in seen_k5:  # a rehearsal's 2^14 prover runs no msm_device2
        k5_err = kernel_vs_plain(torch, "bucket_reduce", seen_k5["bucket_reduce"])
        k5_rows = int(seen_k5["bucket_reduce"][1]["x"].shape[0])
        log(f"K5 in the prover's largest msm_device2 ({k5_rows} buckets): "
            f"max |kernel - plain| {k5_err}")
    elif not args.rehearse:
        raise PhaseError("the compression prover made no K5 call")
    if k5_err:
        raise PhaseError(f"K5 disagrees with its plain version in compression: {k5_err}")

    # the random instance's W commit against the native host MSM
    U, W = pair["U"], pair["W"]
    ck = pp.ck_primary
    host = native.msm_cached(ck.curve, ck.host_arrays(len(W.W)), list(W.W)).add(ck.h.mul(W.r_W))
    if U.comm_W.point != host:
        raise PhaseError("the randomizer's W commit != the native host MSM")
    log(f"randomizer W commit ({len(W.W)} scalars) == native host MSM")
    return {"setup_s": setup_s, "prove_ms": prove_s * 1e3, "phase_ms": phases,
            "verify_ms": verify_s * 1e3, "launches": launches, "k1_err": k1_err,
            "snark": snark, "vk": vk, "steps": rs.i,
            "k1_rows": k1_rows, "k5_err": k5_err, "outer_route": o["route"],
            "outer_rounds": o["rounds"],
            "outer_ms": o["ms"], "other_route_ms": routes["other_ms"],
            "sharded_route_ms": routes["sharded_ms"]}


def kernel_call(name: str, args):
    """A call of kernel `name`'s wrapper on captured arguments."""
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.ops import msm2, msm3

    if name == "bucket_reduce":
        return lambda: msm2._bucket_reduce(*args[:2])
    if name == "stage":
        return lambda: msm2.stage(*args)
    fn = {"mont_mul": fk.mont_mul, "xyzz_add": fk.xyzz_add, "xyzz_double": fk.xyzz_double,
          "accum": msm3.accum, "suffix_segmented": msm3.suffix_to_buckets}[name]
    return lambda: fn(*args)


def shape_times(torch, calls, reps: int) -> dict:
    """Each kernel's time on recorded calls [(label, args), ...], the first
    call of each kernel: device ms under the profiler, else CUDA events."""
    shapes = {}
    for label, a in calls:
        name = label.split("/")[0]
        if name in shapes:
            continue
        fn = kernel_call(name, a)
        t = device_ms(torch, fn, reps)
        timer = "profiler" if torch.cuda.is_available() else "host clock"
        if t is None:
            t, timer = cuda_ms(torch, fn, reps), "events"
        shapes[name] = {"rows": list(first_input(a).shape), "ms": t, "timer": timer}
    return shapes


def mercury_compression(args, torch, pp, rs, z0) -> dict:
    """Phase 9's Mercury step: CompressedSNARK with Mercury on the BN254
    primary and IPA on the secondary (setup, prove by phase, verify) on
    phase 9's RecursiveSNARK, its launches, proofs with zn or one Mercury
    argument field changed failing, and the largest msm_device2 commit made
    inside Mercury's prover against the native host MSM."""
    from nova_tpu_torch import _build, constants, native, profiling
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider.mercury import EvaluationEngine as Mercury

    log("phase 9: Mercury compression (Mercury on the BN254 primary, IPA on the secondary)")
    largest, inside = {}, []
    real_msm, real_prove = msm2.msm_device2, Mercury.prove

    def recording_msm(scalars, *a, **k):
        out = real_msm(scalars, *a, **k)
        if inside and len(scalars) >= largest.get("n", -1):
            largest.update(n=len(scalars), scalars=list(scalars), out=out)
        return out

    def recording_prove(*a, **k):
        inside.append(1)
        try:
            return real_prove(*a, **k)
        finally:
            inside.pop()

    _profile(True)
    msm2.msm_device2 = recording_msm
    Mercury.prove = staticmethod(recording_prove)
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        pk, vk = CompressedSNARK.setup(pp, ee1=Mercury)
        setup_s = time.perf_counter() - t0
        profiling.global_reset()
        t0 = time.perf_counter()
        snark = CompressedSNARK.prove(pp, pk, rs)
        sync(torch)
        prove_s = time.perf_counter() - t0
        phases = {k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()}
        t0 = time.perf_counter()
        out = snark.verify(vk, rs.i, z0)
        sync(torch)
        verify_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        msm2.msm_device2, Mercury.prove = real_msm, staticmethod(real_prove)
        _profile(False)
    if out != list(rs.zi):
        raise PhaseError(f"Mercury compressed verify returned {out}, expected {rs.zi}")
    log(f"Mercury compression: setup {setup_s:.2f} s, prove {prove_s:.2f} s, verify "
        f"{verify_s:.2f} s; phases (ms) {json.dumps(phases)}; launches {launches}")
    missing = [k for k in COMPRESS_KERNELS if launches[k] == 0]
    if missing and not args.rehearse:
        raise PhaseError(f"kernels not launched on the Mercury compression: {missing}")

    r = pp.engine1.scalar.p
    zn, arg = list(snark.zn), snark.snark_primary.eval_arg
    g = arg.g_zeta
    tampered_fail(lambda: snark.verify(vk, rs.i, z0), [
        ("zn", lambda: setattr(snark, "zn", [(z + 1) % r for z in zn]),
         lambda: setattr(snark, "zn", zn)),
        ("Mercury's g_zeta", lambda: setattr(arg, "g_zeta", (g + 1) % r),
         lambda: setattr(arg, "g_zeta", g)),
    ])

    host_ms = None
    if largest:
        ck, n = pp.ck_primary, largest["n"]
        t0 = time.perf_counter()
        host = native.msm_cached(ck.curve, ck.host_arrays(n), largest["scalars"])
        host_ms = (time.perf_counter() - t0) * 1e3
        if host != largest["out"]:
            raise PhaseError(f"Mercury's {n}-scalar msm_device2 commit != the native host MSM")
        log(f"Mercury's largest msm_device2 commit ({n} scalars) == the native host MSM")
    elif not args.rehearse:
        raise PhaseError("Mercury's prover made no msm_device2 commit "
                         f"(none of >= {constants.DEVICE_THRESHOLD} scalars)")
    return {"setup_s": setup_s, "prove_ms": prove_s * 1e3, "phase_ms": phases,
            "verify_ms": verify_s * 1e3, "launches": launches,
            "largest_msm_device2": largest.get("n"), "host_msm_ms": host_ms}


def kzg_path(args, torch, dev, workers: int) -> dict:
    """Phase 9: BN254/Grumpkin with HyperKZG. A test ptau file (written from
    a tau drawn from SEED, or reused), PublicParams.setup_with_ptau_dir on
    the card with a squaring chain whose BN254 primary pads to 2^17
    constraints, RecursiveSNARK.new, KZG_STEPS prove_steps (timed by phase)
    and verify, then CompressedSNARK with HyperKZG on the primary and IPA on
    the secondary (prove timed by phase) and verify, the counts reset just
    before new and read just after compression's verify; tampered proofs;
    every kernel of the path against its plain version on this path's
    inputs and timed there."""
    import numpy as np

    from nova_tpu_torch import _build, native, profiling
    from nova_tpu_torch.curves.spec import bn254
    from nova_tpu_torch.frontend.constraint_system import ShapeCS
    from nova_tpu_torch.nova.circuit import NovaAugmentedCircuit, TrivialCircuit
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider import ptau
    from nova_tpu_torch.provider.engines import Bn256EngineIPA, GrumpkinEngine
    from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as KZG
    from nova_tpu_torch.provider.poseidon import PoseidonROConstants

    power = REHEARSE_PTAU_POWER if args.rehearse else PTAU_POWER
    log_cons = REHEARSE_FOLD_LOG_CONS if args.rehearse else FOLD_LOG_CONS
    reps = 1 if args.rehearse else 5
    log(f"== phase 9: BN254/Grumpkin with HyperKZG (ptau power {power}, primary "
        f"2^{log_cons} constraints, {KZG_STEPS} prove_steps)")
    if not native.available():
        raise PhaseError("the native host binding did not build (native/nova_native.cpp)")

    # the ptau file: written once under the git-ignored build directory, at
    # the power of phase 10's spark key; this phase reads its 2^log_cons
    # points from it (find_ptau_file takes the smallest file that fits)
    d = os.path.join(native.BUILD_ROOT, "ptau")
    path = os.path.join(d, f"ppot_pruned_{power:02d}.ptau")
    t0 = time.perf_counter()
    wrote = not os.path.exists(path)
    if wrote:
        os.makedirs(d, exist_ok=True)
        r = bn254.scalar.p
        tau = int.from_bytes(np.random.default_rng(SEED).bytes(32), "little") % r
        tmp = f"{path}.{os.getpid()}.tmp"
        ptau.write_test_ptau(tmp, tau, power)
        os.replace(tmp, path)
    ptau_s = time.perf_counter() - t0
    log(f"ptau: {'wrote' if wrote else 'reused'} {os.path.relpath(path)} "
        f"({os.path.getsize(path)} B) in {ptau_s:.1f} s")

    # the squaring chain that pads the BN254 primary to 2^log_cons
    cs = ShapeCS(Bn256EngineIPA.scalar)
    NovaAugmentedCircuit(GrumpkinEngine, True, None, TrivialCircuit(),
                         PoseidonROConstants(GrumpkinEngine.base)).synthesize(cs)
    base = cs.r1cs_shape().num_cons
    squares = (1 << log_cons) - base
    circuit = square_chain(squares)
    t0 = time.perf_counter()
    pp = PublicParams.setup_with_ptau_dir(Bn256EngineIPA, GrumpkinEngine, circuit, d,
                                          device=dev)
    setup_s = time.perf_counter() - t0
    log(f"setup_with_ptau_dir: the trivial BN254 primary has {base} constraints; "
        f"constraints {pp.num_constraints()}, variables {pp.num_variables()}, keys "
        f"{len(pp.ck_primary)}/{len(pp.ck_secondary)} on {pp.ck_primary.device}, "
        f"{setup_s:.1f} s")
    if pp.num_constraints()[0] != 1 << log_cons or len(pp.ck_primary) != 1 << log_cons:
        raise PhaseError(f"primary {pp.num_constraints()[0]} constraints, "
                         f"key {len(pp.ck_primary)}: 2^{log_cons} expected")

    _profile(True)
    run = drive_steps(torch, pp, circuit, KZG_STEPS, squares, bn254.scalar.p)
    rs, z0, step_s = run["rs"], run["z0"], run["step_s"]
    step_launches, step_phases = run["step_launches"], run["step_phases"]
    r = bn254.scalar.p
    log("replayed prove_step phases (ms): " + json.dumps(step_phases[2:]))

    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    pk, vk = CompressedSNARK.setup(pp, ee1=KZG)
    csetup_s = time.perf_counter() - t0
    profiling.global_reset()
    t0 = time.perf_counter()
    snark = CompressedSNARK.prove(pp, pk, rs)
    sync(torch)
    prove_s = time.perf_counter() - t0
    cphases = {k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()}
    t0 = time.perf_counter()
    cout = snark.verify(vk, rs.i, z0)
    sync(torch)
    cverify_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    compress_launches = launch_delta(_build, before)
    _profile(False)
    if cout != list(rs.zi):
        raise PhaseError(f"compressed verify returned {cout}, expected {rs.zi}")
    log(f"compression (HyperKZG primary, IPA secondary): setup {csetup_s:.2f} s, prove "
        f"{prove_s:.2f} s, verify {cverify_s:.2f} s; phases (ms) {json.dumps(cphases)}")
    log(f"path launches (new to compression's verify) {launches}")

    # a proof with zn, or with one HyperKZG witness, changed fails
    zn, w = list(snark.zn), snark.snark_primary.eval_arg.w
    w1 = w[1]
    tampered_fail(lambda: snark.verify(vk, rs.i, z0), [
        ("zn", lambda: setattr(snark, "zn", [(z + 1) % r for z in zn]),
         lambda: setattr(snark, "zn", zn)),
        ("a HyperKZG witness", lambda: w.__setitem__(1, w1 + w[0]),
         lambda: w.__setitem__(1, w1)),
    ])

    # the path launched every kernel, and K3 once a window in the KZG key's
    # window precomputes (one per window size and padded length it met)
    fixed = list(pp.ck_primary._db._fixed) if pp.ck_primary._db is not None else []
    k3_want = sum(msm2._num_windows2(c) - 1 for c, _ in fixed)
    if not args.rehearse:
        missing = [k for k in KZG_KERNELS if launches[k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the KZG path: {missing}")
        if launches["xyzz_double"] != k3_want or not k3_want:
            raise PhaseError(f"K3 launched {launches['xyzz_double']} times on the KZG path, "
                             f"expected once a window of the key's precomputes {fixed}: "
                             f"{k3_want}")
    log(f"K3: {launches['xyzz_double']} launches, one a window of the KZG key's "
        f"precomputes (window, lanes) {fixed}")

    merc = mercury_compression(args, torch, pp, rs, z0)

    chk = path_kernels(args, torch, dev, pp, rs, workers, reps, timed=False)
    shapes = shape_times(torch, list(chk["seen"].items()) + [("stage", chk["stage_first"])],
                         reps)
    log("kernels at the KZG path's shapes: " + json.dumps(shapes))

    replay = step_phases[2:]
    return {
        "ptau_s": ptau_s, "ptau_written": wrote, "setup_s": setup_s, "new_s": run["new_s"],
        "base_constraints": base, "squares": squares,
        "prove_step_all_ms": [t * 1e3 for t in step_s],
        "phase_ms": {k: statistics.median(ph.get(k, 0.0) for ph in replay) for k in replay[0]},
        "verify_ms": run["verify_s"] * 1e3, "compress_setup_s": csetup_s, "compress_ms": prove_s * 1e3,
        "compress_phase_ms": cphases, "compress_verify_ms": cverify_s * 1e3,
        "launches": launches, "launches_per_replayed_step": step_launches[2:],
        "compress_launches": compress_launches, "k3_precomputes": fixed,
        "kernel_errs": chk["kernel_errs"], "shape_ms": shapes, "mercury": merc,
        "pp": pp, "ptau_dir": d,
    }


def ppsnark_path(args, torch, dev, workers: int, kzg: dict) -> dict:
    """Phase 10: ppsnark (Spark) on BN254/Grumpkin at phase 9's primary.
    PublicParams.setup_with_ptau_dir with ck_hint1/ck_hint2 = ppsnark's
    ck_floor of phase 9's ShapeCS shapes (the 2^19 KZG key from phase 9's
    ptau file, a 2^17 + 1 Grumpkin key), RecursiveSNARK.new, KZG_STEPS
    prove_steps and verify, then CompressedSNARK with ppsnark on both
    curves (HyperKZG on the primary, IPA on the secondary; prove by phase)
    and verify, the counts reset just before new and read just after
    compression's verify: every kernel of the path must launch, K3 once a
    window of each window precompute (the 2^19 key's among them), and the
    primary's outer sumcheck on the device; proofs with zn, eval_L_row or
    a spark commitment of the vk changed fail; the outer sumcheck again
    through the host prover gives the same proof; the spark row commit at
    N against the native host MSM, with B6 (all three modes), K1, K3 and K5
    against their plain versions on its inputs; msm_device2 and the window
    precompute timed at N, and the native MSM that commits the HVec
    oracles."""
    import numpy as np

    from nova_tpu_torch import _build, constants, native, profiling
    from nova_tpu_torch.curves.spec import bn254
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.ops.fvec import HVec
    from nova_tpu_torch.provider.engines import Bn256EngineIPA, GrumpkinEngine
    from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as KZG
    from nova_tpu_torch.provider.pedersen import CommitmentEngine
    from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as PP

    reps = 1 if args.rehearse else 5
    S1, S2 = kzg["pp"].r1cs_shape_primary, kzg["pp"].r1cs_shape_secondary
    hint1, hint2 = PP.ck_floor(S1), PP.ck_floor(S2)
    log(f"== phase 10: ppsnark on BN254/Grumpkin (primary {S1.num_cons} constraints, "
        f"ck_floor {hint1} / {hint2}, {KZG_STEPS} prove_steps)")
    saved_threshold = constants.DEVICE_THRESHOLD
    if args.rehearse:
        # the augmented circuits' spark vectors are 2^17-2^18 long, too long
        # for the plain msm_device2 on the CPU: a rehearsal commits them on
        # the native host MSM
        constants.DEVICE_THRESHOLD = 1 << 30
        log("rehearsal: DEVICE_THRESHOLD raised, the spark commits take the native host MSM")
    squares = kzg["squares"]
    circuit = square_chain(squares)
    t0 = time.perf_counter()
    pp = PublicParams.setup_with_ptau_dir(Bn256EngineIPA, GrumpkinEngine, circuit,
                                          kzg["ptau_dir"], ck_hint1=hint1, ck_hint2=hint2,
                                          device=dev)
    setup_s = time.perf_counter() - t0
    log(f"setup_with_ptau_dir: keys {len(pp.ck_primary)}/{len(pp.ck_secondary)} on "
        f"{pp.ck_primary.device}, {setup_s:.1f} s")

    precomputes = []  # (window, rows, windows) of each window precompute
    real_pre = msm2._precompute_shifted

    def recording_pre(tf, c, W, bx, *a):
        precomputes.append((c, int(bx.shape[0]), W))
        return real_pre(tf, c, W, bx, *a)

    _profile(True)
    msm2._precompute_shifted = recording_pre
    try:
        with outer_sumchecks(torch) as outer:
            run = drive_steps(torch, pp, circuit, KZG_STEPS, squares, bn254.scalar.p)
            rs, z0 = run["rs"], run["z0"]
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            pk, vk = CompressedSNARK.setup(pp, S1=PP, S2=PP, ee1=KZG)
            sync(torch)
            csetup_s = time.perf_counter() - t0
            profiling.global_reset()
            t0 = time.perf_counter()
            snark = CompressedSNARK.prove(pp, pk, rs)
            sync(torch)
            prove_s = time.perf_counter() - t0
            cphases = {k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()}
            t0 = time.perf_counter()
            cout = snark.verify(vk, rs.i, z0)
            sync(torch)
            cverify_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            compress_launches = launch_delta(_build, before)
    finally:
        msm2._precompute_shifted = real_pre
        _profile(False)
        constants.DEVICE_THRESHOLD = saved_threshold
    if cout != list(rs.zi):
        raise PhaseError(f"ppsnark compressed verify returned {cout}, expected {rs.zi}")
    N1, N2 = pk.pk_primary.S_repr.N, pk.pk_secondary.S_repr.N
    log(f"ppsnark compression (N = {N1} / {N2}): setup {csetup_s:.2f} s, prove "
        f"{prove_s:.2f} s, verify {cverify_s:.2f} s; phases (ms) {json.dumps(cphases)}")
    log(f"path launches (new to compression's verify) {launches}; window precomputes "
        f"(window, rows, windows) {precomputes}")
    k3_want = sum(W - 1 for _, _, W in precomputes)
    if not args.rehearse:
        missing = [k for k in KZG_KERNELS if launches[k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the ppsnark path: {missing}")
        if launches["xyzz_double"] != k3_want or not any(n == N1 for _, n, _ in precomputes):
            raise PhaseError(f"K3 launched {launches['xyzz_double']} times, expected once a "
                             f"window of the precomputes {precomputes} ({k3_want}), among "
                             f"them the {N1}-row key's")
        if outer["route"] != "device":
            raise PhaseError("the primary's outer sumcheck did not take the device route")

    r = bn254.scalar.p
    zn, sp, sc = list(snark.zn), snark.snark_primary, vk.vk_primary.S_comm
    lrow, crow = sp.eval_L_row, sc.comm_row
    tampered_fail(lambda: snark.verify(vk, rs.i, z0), [
        ("zn", lambda: setattr(snark, "zn", [(z + 1) % r for z in zn]),
         lambda: setattr(snark, "zn", zn)),
        ("eval_L_row", lambda: setattr(sp, "eval_L_row", (lrow + 1) % r),
         lambda: setattr(sp, "eval_L_row", lrow)),
        ("the vk's spark row commitment", lambda: setattr(sc, "comm_row", sc.comm_col),
         lambda: setattr(sc, "comm_row", crow)),
    ])
    other_ms = other_route(torch, dev, outer)

    # the spark row commit at N on the card against the native host MSM,
    # and B6, K1, K3 and K5 against their plain versions on its inputs (a
    # rehearsal, whose plain msm_device2 at N would take hours, skips this)
    kernel_errs, checked, stage_rows, shapes, timing = {}, {}, {}, {}, {}
    row_ms = host_ms = None
    modes = []
    if not args.rehearse:
        ck = pp.ck_primary
        row = list(pk.pk_primary.S_repr.row)
        db = ck.device_bases2(N1)
        t0 = time.perf_counter()
        got2, captured = recorded_stages(lambda: msm2.msm_device2(row, device_bases=db,
                                                                  reuse=True))
        row_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = native.msm_cached(ck.curve, ck.host_arrays(N1), row)
        host_ms = (time.perf_counter() - t0) * 1e3
        if not got2 == host == pk.pk_primary.S_comm.comm_row.point:
            raise PhaseError(f"spark row commit: msm_device2 {got2}, native {host}, "
                             f"vk {pk.pk_primary.S_comm.comm_row.point}")
        modes = sorted({a[4] for a, _ in captured})
        log(f"spark row commit ({N1} scalars, max {max(row).bit_length()} bits): msm_device2 "
            f"{row_ms:.1f} ms == native host MSM {host_ms:.1f} ms == the vk's; B6 modes {modes}"
            f"{' (the complete rerun was taken)' if 'complete' in modes else ''}")
        stage_rows, kernel_errs["stage"], first = stage_modes(torch, captured, reps, True)
        seen, fresh, warm, precompute = precompute_kernels(row, db, got2)
        for label, a in seen.items():
            e = kernel_vs_plain(torch, label, a)
            kernel_errs[label] = e
            checked[label] = {"rows": list(first_input(a).shape), "max_abs_err": e}
        log(f"spark row commit kernels against their plain versions: {json.dumps(checked)}")
        bad = {k: e for k, e in kernel_errs.items() if e}
        if bad:
            raise PhaseError(f"spark commit kernels disagree with their plain versions: {bad}")
        shapes = shape_times(torch, list(seen.items()) + [("stage", first)], reps)
        log("kernels at the spark commit's shapes: " + json.dumps(shapes))

        # msm_device2 at N (the row vector and a full-width one), the N-row
        # window precompute, and the native host MSM on the full-width
        # vector as an HVec (the route of L_row, L_col and the four memory
        # oracles)
        rng = np.random.default_rng(SEED + 10)
        raw = rng.bytes(32 * N1)
        full = [int.from_bytes(raw[32 * i : 32 * i + 32], "little") % r for i in range(N1)]
        hv = HVec(r, ints=full)
        hv.limbs64()

        def median_ms(fn, k=3):
            fn()
            sync(torch)
            ts = []
            for _ in range(k):
                t0 = time.perf_counter()
                fn()
                sync(torch)
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        timing = {
            "n": N1, "msm_device2_row_ms": median_ms(
                lambda: msm2.msm_device2(row, device_bases=db, reuse=True)),
            "msm_device2_full_ms": median_ms(
                lambda: msm2.msm_device2(full, device_bases=db, reuse=True)),
            "native_hvec_commit_ms": median_ms(lambda: CommitmentEngine.commit(ck, hv)),
            "precompute_launches": precompute, "msm_device2_launches": warm,
        }
        c = msm2._window_for(N1)
        bx, by, binf = msm2._sized(fresh, N1)
        timing["precompute_ms"] = precompute_ms(
            torch, lambda: msm2._precompute_shifted(fresh.tf, c, msm2._num_windows2(c),
                                                    bx, by, binf))
        log("spark-size timings: " + json.dumps(timing))

    replay = run["step_phases"][2:]
    return {
        "setup_s": setup_s, "ck_floor": [hint1, hint2], "N": [N1, N2], "new_s": run["new_s"],
        "prove_step_all_ms": [t * 1e3 for t in run["step_s"]],
        "phase_ms": {k: statistics.median(ph.get(k, 0.0) for ph in replay) for k in replay[0]},
        "verify_ms": run["verify_s"] * 1e3, "compress_setup_s": csetup_s,
        "compress_ms": prove_s * 1e3, "compress_phase_ms": cphases,
        "compress_verify_ms": cverify_s * 1e3, "launches": launches,
        "compress_launches": compress_launches, "precomputes": precomputes,
        "outer_route": outer["route"], "outer_ms": outer["ms"], "other_route_ms": other_ms,
        "row_commit_ms": row_ms, "row_host_ms": host_ms, "row_modes": modes,
        "kernel_errs": kernel_errs, "stage_modes": stage_rows, "shape_ms": shapes,
        "timing": timing,
    }


def direct_path(args, torch, dev) -> dict:
    """Phase 11: DirectSNARK with ppsnark on Pallas (benches/ppsnark.rs's
    shape): a squaring chain of DIRECT_SQUARES squares, so that the spark
    vectors are N = 2^17 long and the key is phase 5's 2^17 + 1 Pallas key;
    setup (the spark commits must take msm_device2), prove, verify of
    z = 2 -> 2^(2^squares), and a changed io failing."""
    from nova_tpu_torch import _build
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider.engines import PallasEngine
    from nova_tpu_torch.spartan.direct import DirectSNARK
    from nova_tpu_torch.spartan.ppsnark import RelaxedR1CSSNARK as PP

    squares = REHEARSE_DIRECT_SQUARES if args.rehearse else DIRECT_SQUARES
    log(f"== phase 11: DirectSNARK with ppsnark on Pallas ({squares} squares)")
    circuit = square_chain(squares)
    calls = []  # the lengths of the msm_device2 calls
    real = msm2.msm_device2

    def counting(scalars, *a, **k):
        calls.append(len(scalars))
        return real(scalars, *a, **k)

    _build.reset_launches()
    msm2.msm_device2 = counting
    try:
        t0 = time.perf_counter()
        pk, vk = DirectSNARK.setup(PallasEngine, circuit, S_snark=PP, device=dev)
        sync(torch)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        snark = DirectSNARK.prove(PallasEngine, pk, circuit, [2], S_snark=PP)
        sync(torch)
        prove_s = time.perf_counter() - t0
    finally:
        msm2.msm_device2 = real
    N, S = pk.pk.S_repr.N, pk.S
    p = pallas.scalar.p
    io = [2, pow(2, pow(2, squares, p - 1), p)]
    t0 = time.perf_counter()
    snark.verify(PallasEngine, vk, io)
    verify_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    spark_calls = calls.count(N)
    log(f"shape {S.num_cons} x {S.num_vars}, nnz {PP.ck_floor(S)}, N = {N}, key {len(pk.ck)}; "
        f"setup {setup_s:.2f} s, prove {prove_s:.2f} s, verify {verify_s:.2f} s; "
        f"msm_device2 calls of N scalars {spark_calls}; launches {launches}")
    tampered_fail(lambda: snark.verify(PallasEngine, vk, io), [
        ("io", lambda: io.__setitem__(1, (io[1] + 1) % p),
         lambda: io.__setitem__(1, (io[1] - 1) % p)),
    ])
    if not args.rehearse:
        if N != 1 << DIRECT_LOG_N or len(pk.ck) != 1 << DIRECT_LOG_N:
            raise PhaseError(f"N = {N}, key {len(pk.ck)}: 2^{DIRECT_LOG_N} expected")
        missing = [k for k in COMPRESS_KERNELS if launches[k] == 0]
        if spark_calls < 7 or missing:
            raise PhaseError(f"the spark commits did not take msm_device2: {spark_calls} "
                             f"calls of {N} scalars, kernels not launched {missing}")
    return {"squares": squares, "N": N, "shape": [S.num_cons, S.num_vars],
            "setup_s": setup_s, "prove_ms": prove_s * 1e3, "verify_ms": verify_s * 1e3,
            "msm_device2_spark_calls": spark_calls, "launches": launches}


def sha256_circuit(msg: bytes):
    """benches/sha256.py's step circuit on `msg` instead of its all-zero
    bits: SHA-256 of the message's bits, each allocated by a closure that
    returns it (so a witness tape replays it); z passes through. The
    digest's Booleans of the latest synthesis stay on `digest` (a replay
    refreshes their values)."""
    from nova_tpu_torch.frontend.boolean import AllocatedBit, Boolean
    from nova_tpu_torch.frontend.sha256 import sha256
    from nova_tpu_torch.nova.circuit import StepCircuit

    bits = [bool((byte >> (7 - i)) & 1) for byte in msg for i in range(8)]

    class Sha256Circuit(StepCircuit):
        digest = None

        def arity(self):
            return 1

        def synthesize(self, cs, z):
            self.digest = sha256(cs, [Boolean.from_bit(AllocatedBit.alloc(cs, lambda b=b: b))
                                      for b in bits])
            return [z[0]]

    return Sha256Circuit()


def sha256_path(args, torch, dev, workers: int) -> dict:
    """Phase 12: the SHA-256 step circuit (benches/sha256.py) on a
    SHA_MSG_BYTES-byte message drawn from SEED, Pallas/Vesta with phase 5's
    cached keys: PublicParams.setup on the card, new, SHA_STEPS prove_steps
    (the bump, the tape build, one timed replay, by phase) and verify, the
    counts reset just before new and read just after verify (K1, K5 and B6
    must launch; K3 not in the replay); the gadget's digest bits equal
    hashlib's; then phase 6's checks on this path's inputs (path_kernels:
    the fresh primary witness by msm_device2, msm_device3 and the host
    Pippenger, B6 in its three modes, K1, K3 and K5 in the rebuilt
    precompute, K4, K2s and K2 in the running witness's commit, the device
    cross-term), the fresh witness also against the native host MSM, and
    msm_device2 timed on it."""
    import hashlib

    import numpy as np

    from nova_tpu_torch import _build, constants, native
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.nova.ivc import PublicParams
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine

    nbytes = REHEARSE_SHA_MSG_BYTES if args.rehearse else SHA_MSG_BYTES
    reps = 1 if args.rehearse else 5
    log(f"== phase 12: SHA-256 IVC (a {nbytes}-byte message, Pallas/Vesta, "
        f"{SHA_STEPS} prove_steps)")
    msg = np.random.default_rng(SEED + 12).bytes(nbytes)
    circuit = sha256_circuit(msg)
    t0 = time.perf_counter()
    pp = PublicParams.setup(PallasEngine, VestaEngine, circuit, device=dev)
    setup_s = time.perf_counter() - t0
    cons, nvars = pp.num_constraints()[0], pp.num_variables()[0]
    log(f"setup: constraints {pp.num_constraints()} ({cons - AUGMENTED_PRIMARY_CONS} in the "
        f"gadget), variables {pp.num_variables()}, keys {len(pp.ck_primary)}/"
        f"{len(pp.ck_secondary)} on {pp.ck_primary.device}, {setup_s:.1f} s")
    if not args.rehearse and cons < constants.DEVICE_THRESHOLD:
        raise PhaseError(f"the SHA-256 primary has {cons} constraints, under DEVICE_THRESHOLD")

    _profile(True)
    run = drive_steps(torch, pp, circuit, SHA_STEPS, 0, pallas.scalar.p)
    _profile(False)
    launches = dict(_build.LAUNCHES)
    rs, step_launches, step_phases = run["rs"], run["step_launches"], run["step_phases"]
    got = 0
    for b in circuit.digest:
        got = (got << 1) | (1 if b.get_value() else 0)
    want = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    if got != want:
        raise PhaseError(f"the gadget's digest {got:064x} != hashlib's {want:064x}")
    log(f"digest after the replayed step == hashlib.sha256: {want:064x}")
    log(f"SHA-256 path launches (new to verify) {launches}; replayed step "
        f"{step_launches[2:]}; replayed phases (ms) {json.dumps(step_phases[2:])}")
    if not args.rehearse:
        missing = [k for k in ("mont_mul", "bucket_reduce", "stage") if launches[k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the SHA-256 path: {missing}")
        k3 = [sl["xyzz_double"] for sl in step_launches[2:]]
        if any(k3):
            raise PhaseError(f"K3 launched in a replayed SHA-256 step: {k3}")

    chk = path_kernels(args, torch, dev, pp, rs, workers, reps, timed=True)
    witness, db, got2 = chk["witness"], chk["db"], chk["got2"]
    ck = pp.ck_primary
    host = native.msm_cached(ck.curve, ck.host_arrays(len(witness)), witness)
    if host != got2:
        raise PhaseError("the fresh SHA-256 witness: msm_device2 != the native host MSM")
    ones = sum(1 for w in witness if w == 1)
    zeros = sum(1 for w in witness if w == 0)
    log(f"fresh witness == native host MSM; {len(witness)} scalars: {zeros} zero, {ones} one, "
        f"{len(witness) - zeros - ones} other")
    ts = []
    for _ in range(3 if not args.rehearse else 1):
        t0 = time.perf_counter()
        msm2.msm_device2(witness, device_bases=db, reuse=True)
        sync(torch)
        ts.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    native.msm_cached(ck.curve, ck.host_arrays(len(witness)), witness)
    native_ms = (time.perf_counter() - t0) * 1e3
    shapes = shape_times(torch, list(chk["seen"].items()) + [("stage", chk["stage_first"])],
                         reps)
    log(f"msm_device2 on the witness {statistics.median(ts) * 1e3:.1f} ms (native host MSM "
        f"{native_ms:.1f} ms); kernels at the SHA-256 path's shapes: {json.dumps(shapes)}")
    replay = step_phases[2:]
    return {
        "message_bytes": nbytes, "constraints": cons, "variables": nvars,
        "gadget_constraints": cons - AUGMENTED_PRIMARY_CONS, "setup_s": setup_s,
        "new_s": run["new_s"], "prove_step_all_ms": [t * 1e3 for t in run["step_s"]],
        "phase_ms": {k: statistics.median(ph.get(k, 0.0) for ph in replay) for k in replay[0]},
        "verify_ms": run["verify_s"] * 1e3, "launches": launches,
        "launches_per_replayed_step": step_launches[2:], "verify_launches": run["verify_launches"],
        "witness": {"n": len(witness), "zero": zeros, "one": ones},
        "msm_device2_ms": statistics.median(ts) * 1e3, "native_msm_ms": native_ms,
        "stage_modes": chk["stage_rows"], "kernel_errs": chk["kernel_errs"],
        "commit_T_ms": chk["commit_T_ms"], "shape_ms": shapes, "pp": pp,
    }


def neutron_path(args, torch, dev) -> dict:
    """Phase 13: NeutronNova IVC on Pallas with a squaring chain that fills
    the augmented circuit's padded 2^17 x 2^17 structure (its trivial
    counts read from a ShapeCS), phase 5's key: setup on the card, new, NEUTRON_STEPS
    prove_steps (by phase) and verify, which must return
    z0^(2^(steps * squares)); the counts reset just before new and read just
    after verify (K1, K5 and B6 must launch); the folded instance with
    T + 1 fails Structure.is_sat; the last step's W commit against the
    native host MSM, and B6 against its plain version in its modes on the
    stage inputs of that commit."""
    from nova_tpu_torch import _build, native, profiling
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.errors import NovaError
    from nova_tpu_torch.frontend.constraint_system import ShapeCS
    from nova_tpu_torch.neutron import FoldedInstance
    from nova_tpu_torch.neutron.circuit import NeutronAugmentedCircuit
    from nova_tpu_torch.neutron.ivc import PublicParams, RecursiveSNARK
    from nova_tpu_torch.nova.circuit import TrivialCircuit
    from nova_tpu_torch.ops import msm2
    from nova_tpu_torch.provider.engines import PallasEngine, VestaEngine
    from nova_tpu_torch.provider.pedersen import CommitmentEngine
    from nova_tpu_torch.provider.poseidon import PoseidonROConstants

    log_cons = REHEARSE_FOLD_LOG_CONS if args.rehearse else FOLD_LOG_CONS
    log(f"== phase 13: NeutronNova IVC (Pallas, 2^{log_cons} constraints, "
        f"{NEUTRON_STEPS} prove_steps)")
    # one constraint and one variable a square: the chain brings the
    # variables (the trivial circuit has more of them than constraints) to
    # 2^log_cons - 1, so the structure pads to 2^log_cons x 2^log_cons.
    # (R1CSShape.pad keeps a shape's unpadded matrices when its variables
    # are already a power of two, as the JAX package's does; the host SpMV
    # then returns fewer rows than the padded count.)
    cs = ShapeCS(PallasEngine.scalar)
    NeutronAugmentedCircuit(None, TrivialCircuit(),
                            PoseidonROConstants(PallasEngine.scalar)).synthesize(cs)
    trivial = cs.r1cs_shape()
    squares = (1 << log_cons) - max(trivial.num_cons, trivial.num_vars) - 1
    circuit = square_chain(squares)
    t0 = time.perf_counter()
    pp = PublicParams.setup(PallasEngine, VestaEngine, circuit, device=dev)
    setup_s = time.perf_counter() - t0
    S = pp.structure.S
    log(f"setup: the trivial augmented circuit has {trivial.num_cons} constraints and "
        f"{trivial.num_vars} variables, {squares} squares; structure "
        f"{S.num_cons} x {S.num_vars} (left {pp.structure.left}, right "
        f"{pp.structure.right}), key {len(pp.ck)} on {pp.ck.device}, {setup_s:.1f} s")
    if S.num_cons != 1 << log_cons or len(pp.ck) != 1 << log_cons:
        raise PhaseError(f"the Neutron structure has {S.num_cons} constraints, its key "
                         f"{len(pp.ck)} generators")

    z0 = [2]
    p = pallas.scalar.p
    _profile(True)
    _build.reset_launches()
    t0 = time.perf_counter()
    rs = RecursiveSNARK.new(pp, circuit, z0)
    sync(torch)
    new_s = time.perf_counter() - t0
    step_s, step_phases, step_launches = [], [], []
    for _ in range(NEUTRON_STEPS):
        before = dict(_build.LAUNCHES)
        profiling.global_reset()
        t0 = time.perf_counter()
        rs.prove_step(pp, circuit)
        sync(torch)
        step_s.append(time.perf_counter() - t0)
        step_phases.append({k: v * 1e3 for k, v in profiling._GLOBAL.totals.items()})
        step_launches.append(launch_delta(_build, before))
    _profile(False)
    t0 = time.perf_counter()
    out = rs.verify(pp, NEUTRON_STEPS, z0)
    sync(torch)
    verify_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = pow(z0[0], pow(2, squares * NEUTRON_STEPS, p - 1), p)
    if out != [want]:
        raise PhaseError(f"Neutron verify returned {out}, expected [{want}]")
    log(f"new {new_s:.2f} s; prove_step s {[round(t, 3) for t in step_s]}; verify "
        f"{verify_s:.2f} s == z0^(2^({squares} * {NEUTRON_STEPS})) mod p; phases (ms) "
        f"{json.dumps(step_phases[1:])}; launches {launches}")
    if not args.rehearse:
        missing = [k for k in ("mont_mul", "bucket_reduce", "stage") if launches[k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched on the Neutron path: {missing}")

    U = rs.r_U
    bad = FoldedInstance(U.comm_W, U.comm_E, (U.T + 1) % p, U.u, U.X)
    try:
        pp.structure.is_sat(pp.ck, bad, rs.r_W)
    except NovaError:
        log("the folded instance with T + 1 fails Structure.is_sat")
    else:
        raise PhaseError("a folded instance with T + 1 satisfied the structure")

    W = rs.l_w
    ck = pp.ck
    got, captured = recorded_stages(lambda: CommitmentEngine.commit(ck, W.W, W.r_W))
    host = native.msm_cached(ck.curve, ck.host_arrays(len(W.W)), W.W).add(ck.h.mul(W.r_W))
    if got.point != host or got != rs.l_u.comm_W:
        raise PhaseError("the Neutron W commit != the native host MSM")
    log(f"W commit ({len(W.W)} scalars) == native host MSM == l_u.comm_W")
    stage_rows, stage_err = {}, 0
    if captured:
        stage_rows, stage_err, _ = stage_modes(torch, captured, 1, timed=False)
    elif not args.rehearse:
        raise PhaseError("the Neutron W commit launched no B6 stage")
    return {
        "trivial": [trivial.num_cons, trivial.num_vars], "squares": squares,
        "constraints": trivial.num_cons + squares, "setup_s": setup_s, "new_s": new_s,
        "prove_step_all_ms": [t * 1e3 for t in step_s], "phase_ms": step_phases,
        "verify_ms": verify_s * 1e3, "launches": launches,
        "launches_per_step": step_launches, "stage_modes": stage_rows,
        "kernel_errs": {"stage": stage_err},
    }


def _ivc_state(rs) -> dict:
    """A Nova RecursiveSNARK's fields as host ints and affine coordinates."""
    from nova_tpu_torch.ops.fvec import as_list

    return {
        "i": rs.i, "zi": list(rs.zi), "ri": (rs.ri_primary, rs.ri_secondary),
        "U": [(U.comm_W.to_coordinates(), U.comm_E.to_coordinates(), list(U.X), U.u)
              for U in (rs.r_U_primary, rs.r_U_secondary)],
        "W": [(as_list(W.W), as_list(W.E), W.r_W, W.r_E)
              for W in (rs.r_W_primary, rs.r_W_secondary)],
        "l_u": (rs.l_u_secondary.comm_W.to_coordinates(), list(rs.l_u_secondary.X)),
        "l_w": (as_list(rs.l_w_secondary.W), rs.l_w_secondary.r_W),
    }


def bytes_path(args, torch, fold: dict, comp: dict, other_pp) -> dict:
    """Phase 14: proofs and checkpoints as bytes. Phase 5's RecursiveSNARK
    (its running witness on the card) saved with checkpoint, loaded under
    the same pp, one more prove_step on it and on the unbroken object with
    secrets.randbelow drawn from one seeded stream for each: both verify
    and are equal field by field; the checkpoint loaded under `other_pp`
    raises; phase 7's CompressedSNARK through proof_to_bytes /
    proof_from_bytes verifies, and with a flipped byte inside a point's
    coordinate fails to load; a dumps_evm round trip gives the same bytes
    and verifies; device_trace around one replayed step writes a trace."""
    import random
    import secrets
    import shutil

    from nova_tpu_torch import checkpoint, native, profiling, serde
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.errors import NovaError
    from nova_tpu_torch.ops.fvec import FVec

    log("== phase 14: proofs and checkpoints as bytes")
    pp, rs, circuit = fold["pp"], fold["rs"], fold["circuit"]
    d = os.path.join(native.BUILD_ROOT, "bytes")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    path = os.path.join(d, "ivc.ckpt")
    t0 = time.perf_counter()
    checkpoint.save_recursive_snark(path, pp, rs)
    save_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    resumed = checkpoint.load_recursive_snark(path, pp)
    load_s = time.perf_counter() - t0
    W = resumed.r_W_primary.W
    log(f"checkpoint after step {rs.i}: {ckpt_bytes} B, save {save_s:.2f} s, "
        f"load {load_s:.2f} s; the running witness back as "
        f"{type(W).__name__} on {getattr(W, 'device', None)}")
    if not args.rehearse and (not isinstance(W, FVec)
                              or W.device.type != pp.ck_primary.device.type):
        raise PhaseError("the resumed running witness is not on the key's device")

    step_ms = {}
    real = secrets.randbelow
    try:
        for label, obj in (("resumed", resumed), ("unbroken", rs)):
            rnd = random.Random(SEED + 14)
            secrets.randbelow = lambda n, _r=rnd: _r.randrange(n)
            t0 = time.perf_counter()
            obj.prove_step(pp, circuit)
            sync(torch)
            step_ms[label] = (time.perf_counter() - t0) * 1e3
    finally:
        secrets.randbelow = real
    if _ivc_state(resumed) != _ivc_state(rs):
        raise PhaseError("the resumed prove_step differs from the unbroken run's")
    p = pallas.scalar.p
    want = [pow(2, pow(2, fold["squares"] * rs.i, p - 1), p)]
    outs = (resumed.verify(pp, rs.i, [2]), rs.verify(pp, rs.i, [2]))
    if outs != (want, want):
        raise PhaseError(f"resumed/unbroken verify returned {outs}, expected {want}")
    log(f"one more prove_step (ms) {json.dumps(step_ms)} (the resumed object builds its "
        f"tape again); equal field by field; both verify at step {rs.i}")
    try:
        checkpoint.load_recursive_snark(path, other_pp)
    except NovaError:
        log("the checkpoint loaded under another pp raises")
    else:
        raise PhaseError("a checkpoint loaded under another pp")

    snark, vk, steps = comp["snark"], comp["vk"], comp["steps"]
    t0 = time.perf_counter()
    raw = checkpoint.proof_to_bytes(snark)
    back = checkpoint.proof_from_bytes(raw)
    rt_s = time.perf_counter() - t0
    if back.verify(vk, steps, [2]) != list(snark.zn) or serde.dumps(back) != raw[8:]:
        raise PhaseError("the CompressedSNARK's bytes did not round-trip")
    curve = snark.r_U_primary.comm_W.point.curve.name.encode()
    tag = b"PS" + len(curve).to_bytes(4, "big") + curve
    bad = bytearray(raw)
    bad[bad.index(tag) + len(tag) + 1 + 5 + 3] ^= 1
    try:
        checkpoint.proof_from_bytes(bytes(bad))
    except NovaError:
        pass
    else:
        raise PhaseError("a proof with a flipped byte inside a point loaded")
    evm = serde.dumps_evm(snark)
    back = serde.loads_evm(evm)
    if serde.dumps_evm(back) != evm or back.verify(vk, steps, [2]) != list(snark.zn):
        raise PhaseError("the dumps_evm round trip failed")
    log(f"CompressedSNARK: {len(raw)} B round-trips and verifies ({rt_s:.2f} s), a flipped "
        f"byte inside a point fails to load; dumps_evm {len(evm)} B round-trips")

    tdir = os.path.join(d, "trace")
    t0 = time.perf_counter()
    with profiling.device_trace(tdir):
        rs.prove_step(pp, circuit)
        sync(torch)
    trace_s = time.perf_counter() - t0
    files = os.listdir(tdir)
    if len(files) != 1 or not os.path.getsize(os.path.join(tdir, files[0])):
        raise PhaseError(f"device_trace wrote {files}")
    with open(os.path.join(tdir, files[0])) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"device_trace around one replayed step ({trace_s:.1f} s): {files[0]}, "
        f"{len(events)} events, {kernels} kernel events")
    shutil.rmtree(d, ignore_errors=True)
    return {"checkpoint_bytes": ckpt_bytes,
            "save_s": save_s, "load_s": load_s, "step_ms": step_ms,
            "proof_bytes": len(raw), "evm_bytes": len(evm), "roundtrip_s": rt_s,
            "trace_events": len(events), "trace_kernel_events": kernels}


def mesh_of(dev):
    """Phase 15's mesh: MESH_DEVICES entries of the card (cuda:0), or of the
    CPU in a rehearsal."""
    from nova_tpu_torch.parallel import make_mesh

    return make_mesh(MESH_DEVICES,
                     devices=["cuda:0" if dev.type == "cuda" else "cpu"] * MESH_DEVICES)


def wall_ms(torch, fn, reps: int) -> float:
    """Median wall ms of fn() up to a synchronise, after one warm-up."""
    fn()
    sync(torch)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(torch)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def mesh_path(args, torch, dev, ck, v, host_point, fold) -> dict:
    """Phase 15: the mesh (MESH_DEVICES x cuda:0). (1) msm_sharded of phase
    2's FVec on phase 2's key, equal to msm_device3_mont and the host MSM,
    timed beside it, with K4, K2s, K5 and K1 on one shard's inputs and K2 on
    the D-row reduction against their plain versions (bitwise) and timed
    there; (2) one prove_step of phase 5's RecursiveSNARK under use_mesh
    against the same step without a mesh on a copy loaded from its
    checkpoint, with the same seeded randomness, twice (the copy's first
    step builds its tape again; the second steps are the replays timed by
    phase): equal field by field, every commit sharded (counted), the meshed
    object verifies; (3)
    graft_entry.dryrun_multichip on the mesh's devices, then a
    CompressedSNARK of its trivial circuit proved with and without the mesh
    from one seeded stream: equal proof_to_bytes, and it verifies; (4)
    graft_entry.entry(): fn(*args) equals the host MSM, and every K1, K2 and
    K3 call it makes equals its plain version (bitwise). The counts are reset
    just before each part and read just after it."""
    import contextlib
    import random
    import secrets
    import shutil

    from nova_tpu_torch import _build, checkpoint, graft_entry, native, parallel, profiling
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.curves.msm_host import msm as host_msm
    from nova_tpu_torch.ops import msm, msm3

    reps = 1 if args.rehearse else 3
    mesh = mesh_of(dev)
    D = mesh.size
    log(f"== phase 15: the mesh ({D} x {mesh.devices[0]})")
    out = {"devices": [str(d) for d in mesh.devices], "launches": {}, "wall_ms": {}}
    t15 = time.perf_counter()

    # -- (1) the sharded MSM of phase 2's scalars on phase 2's key ---------
    t0 = time.perf_counter()
    db = ck.device_bases2(len(v))
    _build.reset_launches()
    got = parallel.msm_sharded(v, mesh=mesh, device_bases=db)
    sync(torch)
    out["launches"]["sharded_msm"] = dict(_build.LAUNCHES)
    single = msm3.msm_device3_mont(v.m, db)
    if got != host_point or single != host_point:
        raise PhaseError(f"msm_sharded {got} / msm_device3_mont {single} != host {host_point}")
    window = 16 if dev.type == "cuda" else 8
    msm_t = {"n": len(v), "window": window,
             "sharded_ms": wall_ms(torch, lambda: parallel.msm_sharded(
                 v, mesh=mesh, device_bases=db), reps),
             "msm_device3_mont_ms": wall_ms(torch, lambda: msm3.msm_device3_mont(v.m, db), reps)}
    log(f"msm_sharded == msm_device3_mont == host msm; launches "
        f"{out['launches']['sharded_msm']}; {json.dumps(msm_t)}")
    if not args.rehearse:
        missing = [k for k in MESH_MSM_KERNELS if out["launches"]["sharded_msm"][k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched by the sharded MSM: {missing}")
    # each kernel of a shard against its plain version (the last shard's
    # inputs: the shards are equal in size), and K2 on the D-row reduction
    with largest_calls({"accum": (msm3, "accum"), "suffix_segmented": (msm3, "suffix_to_buckets"),
                        "bucket_reduce": (msm3, "_bucket_reduce"), "mont_mul": (fk, "mont_mul"),
                        "reduce": (parallel, "_tree_reduce_points")}) as seen:
        parallel.msm_sharded(v, mesh=mesh, device_bases=db)
    errs = {k: kernel_vs_plain(torch, k, seen[k])
            for k in ("accum", "suffix_segmented", "bucket_reduce", "mont_mul")}
    bf, gathered = seen["reduce"]
    reduced = parallel._tree_reduce_points(bf, gathered)
    plain = parallel._tree_reduce_points(bf, {k: t.cpu() for k, t in gathered.items()})
    errs["xyzz_add"] = max_abs_err(torch, {k: t.cpu() for k, t in reduced.items()}, plain)
    log(f"one shard's kernels and the {D}-row reduction against their plain versions "
        f"(max |kernel - plain|): {errs}")
    if any(errs.values()):
        raise PhaseError(f"kernels disagree with their plain versions on the mesh: {errs}")
    a4 = seen["accum"]
    tails = msm3.accum(*a4)[0]
    k1 = seen["mont_mul"]
    k1_rows = torch.broadcast_shapes(k1[1].shape, k1[2].shape).numel() // 16
    # each operand read once at its own shape (the from_mont's one-row
    # constant once), each product row written once
    k1_bytes = sum(t.numel() * t.element_size() for t in k1[1:]) + ROW * k1_rows
    shapes = {
        "accum": (kernel_call("accum", a4), accum_bound(a4[2], *a4[1], tails),
                  f"{a4[1][0]} x {a4[1][1]} grid"),
        "suffix_segmented": (kernel_call("suffix_segmented", seen["suffix_segmented"]),
                             suffix_bound(torch, seen["suffix_segmented"][1],
                                          seen["suffix_segmented"][3]),
                             f"{seen['suffix_segmented'][1].shape[0]} carries"),
        "bucket_reduce": (kernel_call("bucket_reduce", seen["bucket_reduce"]),
                          bucket_reduce_bound(seen["bucket_reduce"][1]["x"].shape[0]),
                          f"{seen['bucket_reduce'][1]['x'].shape[0]} buckets"),
        "mont_mul": (kernel_call("mont_mul", k1), bound(k1_bytes, MUL_OPS * k1_rows),
                     f"{k1_rows} rows"),
        "xyzz_add": (lambda: parallel._tree_reduce_points(bf, gathered),
                     bound(12 * ROW * (D - 1), MUL_OPS * 14 * (D - 1)),
                     f"{D}-row reduction ({D - 1} one-row adds)"),
    }
    out["shape_ms"] = {}
    for name, (fn, (b_ms, b_by), what) in shapes.items():
        out["shape_ms"][name] = {"shape": what, "ms": cuda_ms(torch, fn, reps),
                                 "bound_ms": b_ms, "bound_by": b_by}
    out["kernel_errs"], out["msm"] = errs, msm_t
    log("kernels at the mesh's shapes (ms): " + json.dumps(out["shape_ms"]))
    out["wall_ms"]["sharded_msm"] = (time.perf_counter() - t0) * 1e3

    # -- (2) one prove_step of phase 5's RecursiveSNARK under the mesh -----
    t0 = time.perf_counter()
    pp, rs, circuit = fold["pp"], fold["rs"], fold["circuit"]
    d = os.path.join(native.BUILD_ROOT, "mesh")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    path = os.path.join(d, "ivc.ckpt")
    checkpoint.save_recursive_snark(path, pp, rs)
    # the unbroken object steps under the mesh (its tape replays at once);
    # the copy builds its tape again in its first step
    copies = {"unmeshed": checkpoint.load_recursive_snark(path, pp), "meshed": rs}
    shutil.rmtree(d, ignore_errors=True)
    commits, real_shard = [], parallel.msm_sharded

    def counted(s, *a, **k):
        commits.append((type(s).__name__, len(s)))
        return real_shard(s, *a, **k)

    steps = {label: {"ms": [], "launches": None, "phase_ms": None} for label in copies}
    real_rand = secrets.randbelow
    _profile(True)
    parallel.msm_sharded = counted
    try:
        for k in range(2):  # the copy's first step builds its tape, its second replays it
            for label, obj in copies.items():
                rnd = random.Random(SEED + 15 + k)
                secrets.randbelow = lambda n, _r=rnd: _r.randrange(n)
                commits.clear()
                profiling.global_reset()
                _build.reset_launches()
                t1 = time.perf_counter()
                with (parallel.use_mesh(mesh) if label == "meshed"
                      else contextlib.nullcontext()):
                    obj.prove_step(pp, circuit)
                sync(torch)
                steps[label]["ms"].append((time.perf_counter() - t1) * 1e3)
                steps[label]["launches"] = dict(_build.LAUNCHES)
                steps[label]["phase_ms"] = {
                    n: t * 1e3 for n, t in profiling._GLOBAL.totals.items()}
                if label == "meshed":
                    steps[label]["commits"] = list(commits)
            if _ivc_state(copies["meshed"]) != _ivc_state(copies["unmeshed"]):
                raise PhaseError(f"the meshed prove_step {k + 1} differs from the unmeshed one")
    finally:
        parallel.msm_sharded = real_shard
        secrets.randbelow = real_rand
        _profile(False)
    meshed = copies["meshed"]
    p = pallas.scalar.p
    want = [pow(2, pow(2, fold["squares"] * meshed.i, p - 1), p)]
    if meshed.verify(pp, meshed.i, [2]) != want:
        raise PhaseError("the meshed RecursiveSNARK does not verify")
    # the secondary's cross-term, the primary's witness and cross-term, the
    # secondary's witness
    (c1, c2), (v1, v2) = pp.num_constraints(), pp.num_variables()
    if [n for _, n in steps["meshed"]["commits"]] != [c2, v1, c1, v2]:
        raise PhaseError(f"the meshed step's commits were not all sharded: "
                         f"{steps['meshed']['commits']}")
    out["launches"]["meshed_step"] = steps["meshed"]["launches"]
    out["step"] = steps
    log("prove_step under the mesh == without (twice, field by field), verifies; commits "
        f"through msm_sharded {steps['meshed']['commits']}; " + json.dumps(
            {k: {"ms": v["ms"], "phase_ms": v["phase_ms"], "launches": v["launches"]}
             for k, v in steps.items()}))
    if not args.rehearse:
        if steps["meshed"]["launches"]["xyzz_double"]:
            raise PhaseError("K3 launched in a replayed meshed prove_step")
        missing = [k for k in MESH_MSM_KERNELS if steps["meshed"]["launches"][k] == 0]
        if missing:
            raise PhaseError(f"kernels not launched by the meshed prove_step: {missing}")
    out["wall_ms"]["meshed_step"] = (time.perf_counter() - t0) * 1e3

    # -- (3) the dryrun twin, and its trivial circuit compressed -----------
    t0 = time.perf_counter()
    _build.reset_launches()
    dry = graft_entry.dryrun_multichip(D, devices=[str(x) for x in mesh.devices])
    sync(torch)
    out["launches"]["dryrun"] = dict(_build.LAUNCHES)
    out["wall_ms"]["dryrun"] = (time.perf_counter() - t0) * 1e3
    log(f"dryrun_multichip({D}): checks (a)-(d) and the fold drill passed "
        f"({out['wall_ms']['dryrun']:.0f} ms); launches {out['launches']['dryrun']}")
    t0 = time.perf_counter()
    tpp, trs = dry["pp"], dry["rs"]
    pk, vk = CompressedSNARK.setup(tpp)
    raw, prove_ms = {}, {}
    try:
        for label in ("unmeshed", "meshed"):
            rnd = random.Random(SEED + 151)
            secrets.randbelow = lambda n, _r=rnd: _r.randrange(n)
            _build.reset_launches()
            t1 = time.perf_counter()
            with (parallel.use_mesh(dry["mesh"]) if label == "meshed"
                  else contextlib.nullcontext()):
                proof = CompressedSNARK.prove(tpp, pk, trs)
            sync(torch)
            prove_ms[label] = (time.perf_counter() - t1) * 1e3
            out["launches"][f"{label}_compression"] = dict(_build.LAUNCHES)
            raw[label] = checkpoint.proof_to_bytes(proof)
    finally:
        secrets.randbelow = real_rand
    if raw["meshed"] != raw["unmeshed"]:
        raise PhaseError("the meshed CompressedSNARK's bytes differ from the unmeshed one's")
    if proof.verify(vk, trs.i, [0]) != [0]:
        raise PhaseError("the meshed CompressedSNARK does not verify")
    out["compression"] = {"proof_bytes": len(raw["meshed"]), "prove_ms": prove_ms}
    out["wall_ms"]["dryrun_compression"] = (time.perf_counter() - t0) * 1e3
    log(f"CompressedSNARK of the dryrun's circuit: {len(raw['meshed'])} B, equal with and "
        f"without the mesh, verifies; prove ms {json.dumps(prove_ms)}")

    # -- (4) graft_entry.entry()'s forward step ------------------------------
    t0 = time.perf_counter()
    fn, fargs = graft_entry.entry(device=dev)
    _build.reset_launches()
    x, y, zz, zzz = fn(*fargs)
    sync(torch)
    out["launches"]["entry"] = dict(_build.LAUNCHES)
    f = pallas.base
    got = (f.mul(msm._limbs16_to_int(x), f.inv(msm._limbs16_to_int(zz))),
           f.mul(msm._limbs16_to_int(y), f.inv(msm._limbs16_to_int(zzz))))
    scalars, bases = graft_entry.entry_inputs()
    want = host_msm(scalars, bases)
    if got != (want.x, want.y):
        raise PhaseError("graft_entry.entry()'s forward step != the host MSM")
    # every K1, K2 and K3 call of the entry (K2 over the W x chunk combine
    # lanes, the table merge and the suffix scans, (1, 16) in the Horner
    # finish; K3 at times = c on one row) against its plain version, the
    # plain one over all calls' rows at once
    with every_call({"mont_mul": (fk, "mont_mul"), "xyzz_add": (fk, "xyzz_add"),
                     "xyzz_double": (fk, "xyzz_double")}) as calls:
        fn(*fargs)
    entry_errs, entry_shapes = {}, {}
    for name, cs in calls.items():
        entry_errs[name] = calls_vs_plain(torch, name, cs)
        entry_shapes[name] = sorted({(tuple(first_input(a).shape),)
                                     + tuple(x for x in a[2:] if isinstance(x, int))
                                     for a in cs})
        errs[name] = max(errs.get(name, 0), entry_errs[name])
    log(f"entry()'s kernel calls against their plain versions (max |kernel - plain| over "
        f"{ {k: len(v) for k, v in calls.items()} } calls at {entry_shapes}): {entry_errs}")
    if any(entry_errs.values()):
        raise PhaseError(f"entry()'s kernels disagree with their plain versions: {entry_errs}")
    out["entry_ms"] = wall_ms(torch, lambda: fn(*fargs), reps)
    out["wall_ms"]["entry"] = (time.perf_counter() - t0) * 1e3
    log(f"entry(): msm1 over {len(scalars)} points == host msm; {out['entry_ms']:.1f} ms; "
        f"launches {out['launches']['entry']}")
    if not args.rehearse and any(out["launches"]["entry"][k] == 0 for k in ENTRY_KERNELS):
        raise PhaseError(f"entry() did not launch {ENTRY_KERNELS}: {out['launches']['entry']}")
    out["wall_ms"]["phase"] = (time.perf_counter() - t15) * 1e3
    log(f"phase 15 parts (wall ms): {json.dumps(out['wall_ms'])}; card: "
        f"{smi_line() if not args.rehearse else 'rehearsal on the CPU'}")
    return out


def bench_line(args) -> dict:
    """Phase 16 (a): `python -m nova_tpu_torch.bench` with NOVA_BENCH_FAST=1
    in a subprocess: its last line has bench.py's keys, its headline comes
    from msm3m on the card, and its stage's build_info says the kernel
    library was found, not rebuilt (the no-rebuild contract that stands for
    the JAX package's ops/aot.py). In a rehearsal (no card) it must print
    value 0.0 with an error and exit non-zero."""
    env = {**os.environ, "NOVA_BENCH_FAST": "1"}
    t0 = time.perf_counter()
    # its own process group, so a timeout stops its stage processes too
    proc = subprocess.Popen([sys.executable, "-m", "nova_tpu_torch.bench"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise PhaseError(f"the bench did not finish in {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        raise PhaseError(f"the bench printed no JSON line (rc {proc.returncode}): "
                         f"{stdout[-1000:]} {stderr[-2000:]}")
    log(f"nova_tpu_torch.bench (NOVA_BENCH_FAST=1, {wall:.1f} s, rc {proc.returncode}): "
        + json.dumps(line))
    if set(line) != BENCH_KEYS or line["metric"] != BENCH_METRIC or "backend" not in line["extra"]:
        raise PhaseError(f"the bench's line has not bench.py's shape: {line}")
    if "fallback" in stdout:
        raise PhaseError("the bench reported a fallback")
    out = {"line": line, "wall_s": wall}
    if args.rehearse:
        if proc.returncode == 0 or line["value"] != 0.0 or "error" not in line["extra"]:
            raise PhaseError("without a card the bench must print value 0.0 and an error "
                             "and exit non-zero")
        return out
    build = [ln for ln in lines if ln.startswith("build_info msm3m ")]
    if proc.returncode != 0 or line["extra"]["backend"] != "cuda (msm3m)" or not line["value"] > 0:
        raise PhaseError(f"the bench's headline is not msm3m's on the card (rc "
                         f"{proc.returncode}): {line}; {stderr[-2000:]}")
    if not build:
        raise PhaseError("the bench's msm3m stage printed no build_info")
    info = json.loads(build[0].split(" ", 2)[2])
    log(f"the bench stage's kernel library: {json.dumps(info)}")
    if info.get("built") is not False:
        raise PhaseError(f"the bench's stage rebuilt the kernel library: {info}")
    out["build_info"] = info
    return out


def entry_path(args, torch, dev) -> dict:
    """Phase 16: the entry points. (a) bench_line, while a thread of this
    process computes MinRoot's advice (host Python only); (b) in-process,
    the bench twin's bench_msm("msm1") on the b"bench-msm" key (its result
    against the native host MSM; the counts reset just before and read
    just after), then the K1, K2 and K3 calls of one msm1 MSM on those
    inputs, the latest at each shape, against their plain versions
    (bitwise); (c) examples/minroot's twin, main([MINROOT_ITERS,
    MINROOT_STEPS], device=dev), handed the advice of (a) when it asks for
    that sequence: the RecursiveSNARK and the compressed proof verify
    (main verifies both), z_n equals the advice's last iterate, a proof
    with zn changed fails; the largest K1, K5 and B6 call of the replayed
    (third) prove_step and of the compression against their plain versions
    (bitwise; the K1 calls' plain rows stacked, the K5 tables as one
    batch) and timed at their shapes; the counts reset just before main
    and read just after, and per replayed step and compression. Each
    part's wall seconds are printed. The bench twin's
    bench_fold_and_compress is not run here: its trivial circuit stays
    under DEVICE_THRESHOLD and launches no kernel (the tests hold it
    against bench.py's on the CPU)."""
    from nova_tpu_torch import _build, bench
    from nova_tpu_torch.examples import minroot
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.nova.compressed import CompressedSNARK
    from nova_tpu_torch.nova.ivc import RecursiveSNARK
    from nova_tpu_torch.ops import msm, msm2
    from nova_tpu_torch.provider.engines import PallasEngine

    log("== phase 16: entry points (the bench twin, msm1 at 2^16, MinRoot)")
    t16 = time.perf_counter()
    reps = 1 if args.rehearse else 3
    out = {"launches": {}, "wall_s": {}}
    iters = REHEARSE_MINROOT_ITERS if args.rehearse else MINROOT_ITERS

    # -- (a) the bench twin as a user runs it -------------------------------
    # MinRoot's advice (the VDF's sequential evaluation, host Python only)
    # is computed meanwhile, while this process waits on the bench's; (c)
    # hands it to main() when main asks for the same sequence
    real_seq = minroot.MinRootIteration.seq
    advice = {"key": (PallasEngine.scalar, iters * MINROOT_STEPS, 2, 3)}

    def compute_advice():
        t = time.perf_counter()
        advice["seq"] = real_seq(*advice["key"])
        advice["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    worker = threading.Thread(target=compute_advice)
    worker.start()
    try:
        out["bench"] = bench_line(args)
    finally:
        worker.join()
    out["wall_s"]["bench"] = time.perf_counter() - t0
    if "seq" not in advice:
        raise PhaseError("MinRoot's advice failed beside the bench")
    log(f"MinRoot's advice ({iters * MINROOT_STEPS} iterations) beside the bench: "
        f"{advice['s']:.1f} s")

    # -- (b) msm1 on the bench's key, in-process ------------------------------
    t0 = time.perf_counter()
    msm1_n = 1 << (REHEARSE_LOG_N if args.rehearse else LOG_N)
    _build.reset_launches()
    rate = bench.bench_msm("msm1", n=msm1_n, device=dev, iters=reps)
    sync(torch)
    out["launches"]["msm1"] = dict(_build.LAUNCHES)
    out["msm1"] = {"n": msm1_n, "pts_per_s": rate}
    log(f"bench_msm('msm1') at n = {msm1_n}: == host MSM, {rate:.1f} points/s; launches "
        f"{out['launches']['msm1']}")
    if not args.rehearse and any(out["launches"]["msm1"][k] == 0 for k in ENTRY_KERNELS):
        raise PhaseError(f"msm1 did not launch {ENTRY_KERNELS}: {out['launches']['msm1']}")
    out["wall_s"]["msm1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the K1, K2 and K3 calls of one such MSM against their plain versions,
    # the latest call at each shape: K1 marshalling the bases and in the
    # finish, K2 over the 20 x 2^16 combine lanes, the 20 x 2^13 table
    # merge and scans and the one-row Horner finish, K3 at times = 13
    ck, scalars = bench._msm_inputs(msm1_n, dev)
    with every_call({"mont_mul": (fk, "mont_mul"), "xyzz_add": (fk, "xyzz_add"),
                     "xyzz_double": (fk, "xyzz_double")}, one_per_shape=True) as calls:
        db = msm.DeviceBases(ck.curve, ck.ck[:msm1_n], device=dev)
        msm.msm_device(scalars, device_bases=db)
    out["wall_s"]["msm1_capture"] = time.perf_counter() - t0
    errs, shapes = {}, {}
    for name, cs in calls.items():
        t1 = time.perf_counter()
        errs[name] = calls_vs_plain(torch, name, cs)
        out["wall_s"][f"msm1_{name}_vs_plain"] = time.perf_counter() - t1
        shapes[name] = sorted((tuple(first_input(a).shape),)
                              + tuple(x for x in a[2:] if isinstance(x, int)) for a in cs)
    del calls
    out["msm1"]["shapes"] = shapes
    log(f"msm1's kernel calls against their plain versions, one at each shape (max |kernel "
        f"- plain| at {json.dumps(shapes)}): {errs}")
    if any(errs.values()):
        raise PhaseError(f"msm1's kernels disagree with their plain versions: {errs}")

    # -- (c) MinRoot ----------------------------------------------------------
    t0 = time.perf_counter()
    targets = {"mont_mul": (fk, "mont_mul"), "bucket_reduce": (msm2, "_bucket_reduce"),
               "stage": (msm2, "stage")}
    seen, step_launches = {}, []
    real_step, real_prove = RecursiveSNARK.prove_step, CompressedSNARK.prove

    def step(self, pp, c):
        before = dict(_build.LAUNCHES)
        if len(step_launches) != MINROOT_STEPS - 1:
            res = real_step(self, pp, c)
        else:  # the replay of the tape built by the second step
            with largest_calls(targets) as calls:
                res = real_step(self, pp, c)
            seen["replayed step"] = calls
        step_launches.append(launch_delta(_build, before))
        return res

    def prove(pp, pk, rs):
        before = dict(_build.LAUNCHES)
        with largest_calls(targets) as calls:
            res = real_prove(pp, pk, rs)
        seen["compression"] = calls
        out["launches"]["minroot_compression"] = launch_delta(_build, before)
        return res

    def seq(*key):
        if key != advice["key"]:
            return real_seq(*key)
        advice["handed"] = True
        return advice["seq"]

    RecursiveSNARK.prove_step, CompressedSNARK.prove = step, staticmethod(prove)
    minroot.MinRootIteration.seq = staticmethod(seq)
    try:
        _build.reset_launches()
        mr = minroot.main([str(iters), str(MINROOT_STEPS)], device=dev)
        sync(torch)
    finally:
        RecursiveSNARK.prove_step, CompressedSNARK.prove = real_step, staticmethod(real_prove)
        minroot.MinRootIteration.seq = staticmethod(real_seq)
    out["launches"]["minroot"] = dict(_build.LAUNCHES)
    out["launches"]["minroot_steps"] = step_launches
    last = mr["circuits"][-1].seq[-1]
    if mr["zn"] != [last.x_i_plus_1, last.y_i_plus_1]:
        raise PhaseError(f"MinRoot's z_n {mr['zn']} is not the advice's last iterate")
    proof, zn, p = mr["proof"], list(mr["proof"].zn), mr["pp"].r1cs_shape_primary.field.p

    def changed_zn():
        proof.zn = [(zn[0] + 1) % p] + zn[1:]

    def kept_zn():
        proof.zn = zn

    tampered_fail(lambda: proof.verify(mr["vk"], MINROOT_STEPS, mr["z0"]),
                  [("zn", changed_zn, kept_zn)])
    out["minroot"] = {"iters_per_step": iters, "steps": MINROOT_STEPS,
                      "constraints": list(mr["pp"].num_constraints()),
                      "advice_beside_bench_s": advice["s"],
                      "advice_handed_to_main": advice.get("handed", False),
                      "seconds": mr["seconds"]}
    out["wall_s"]["minroot"] = time.perf_counter() - t0
    log(f"MinRoot {iters} x {MINROOT_STEPS}: verified, compressed and verified; "
        f"{json.dumps(out['minroot'])}; launches {out['launches']['minroot']}")
    if not args.rehearse:
        parts = {"replayed step": step_launches[-1],
                 "compression": out["launches"]["minroot_compression"]}
        missing = {part: [k for k in MINROOT_KERNELS if ls[k] == 0] for part, ls in parts.items()}
        if any(missing.values()) or step_launches[-1]["xyzz_double"]:
            raise PhaseError(f"MinRoot's {MINROOT_KERNELS} must launch in the replayed step and "
                             f"the compression, K3 not in the replay: not launched {missing}, "
                             f"replay {step_launches[-1]}")

    # the largest K1, K5 and B6 call of the replayed step and of the
    # compression against their plain versions, and timed at their shapes
    t0 = time.perf_counter()
    mr_errs, shapes = {}, {}
    for name in MINROOT_KERNELS:
        calls = {part: c[name] for part, c in seen.items() if name in c}
        if not calls:  # a rehearsal's primary stays under DEVICE_THRESHOLD
            continue
        t1 = time.perf_counter()
        if name != "stage":
            mr_errs[name] = calls_vs_plain(torch, name, list(calls.values()))
        else:
            mr_errs[name] = max(kernel_vs_plain(torch, name, a) for a in calls.values())
        out["wall_s"][f"minroot_{name}_vs_plain"] = time.perf_counter() - t1
        shapes[name] = {part: minroot_shape(torch, name, a, reps) for part, a in calls.items()}
    out["wall_s"]["kernel_checks"] = time.perf_counter() - t0
    log(f"MinRoot's largest K1, K5, B6 calls against their plain versions (max |kernel - "
        f"plain|): {mr_errs}; at their shapes: {json.dumps(shapes)}")
    if any(mr_errs.values()):
        raise PhaseError(f"MinRoot's kernels disagree with their plain versions: {mr_errs}")
    for name, e in mr_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    out["kernel_errs"], out["shape_ms"] = errs, shapes
    out["wall_s"]["phase"] = time.perf_counter() - t16
    log(f"phase 16 parts (wall s): {json.dumps(out['wall_s'])}; card: "
        f"{smi_line() if not args.rehearse else 'rehearsal on the CPU'}")
    return out


def minroot_shape(torch, name: str, a, reps: int) -> dict:
    """A captured K1, K5 or B6 call timed (CUDA events) beside its bound."""
    if name == "mont_mul":
        rows = torch.broadcast_shapes(a[1].shape, a[2].shape).numel() // 16
        nbytes = sum(t.numel() * t.element_size() for t in a[1:]) + ROW * rows
        shape, (b_ms, b_by) = f"{rows} rows", bound(nbytes, MUL_OPS * rows)
    elif name == "bucket_reduce":
        nb = a[1]["x"].shape[0]
        shape, (b_ms, b_by) = f"{nb} buckets", bucket_reduce_bound(nb)
    else:
        masks, mode, live = a[2], a[4], a[5]
        shape = f"{masks.shape[1]} lanes x {masks.shape[0]} rounds, {mode}"
        b_ms, b_by = stage_bound(masks, mode, live is not None)
    return {"shape": shape, "ms": cuda_ms(torch, kernel_call(name, a), reps),
            "bound_ms": b_ms, "bound_by": b_by}


def field_ubench(args, torch, dev) -> dict:
    """Phase 8: perf/ubench_field.py's benchmark on the card (its lines, the
    counts reset just before and read just after), then P1 and P2 against
    their plain versions and timed beside their bounds."""
    from nova_tpu_torch import _build
    from nova_tpu_torch.perf import ubench_field as ub

    log_n, iters = ((REHEARSE_UB_LOG_N, REHEARSE_UB_ITERS) if args.rehearse
                    else (UB_LOG_N, UB_ITERS))
    n = 1 << log_n
    reps = 1 if args.rehearse else 5
    log(f"== phase 8: field microbenchmark (P1, P2; N = 2^{log_n}, ITERS = {iters})")
    _build.reset_launches()
    probe_s = ub.main([str(log_n), str(iters)], device=dev)
    sync(torch)
    launches = {k: _build.LAUNCHES[k] for k in UBENCH_KERNELS}
    if not args.rehearse and not all(launches.values()):
        raise PhaseError(f"kernels not launched by the microbenchmark: {launches}")
    t = ub.inputs(n, device=dev)
    rows = {}
    for name, bits, a, b in (("mont16_chain", 16, t["a16"], t["b16"]),
                             ("mont8_chain", 8, t["a8"], t["b8"])):
        fn = getattr(ub, name)
        got = fn(a, b, iters)
        ref = ub.mont_chain_plain(a, b, iters, bits)
        err = int((got.long() - ref.long()).abs().max().item())
        ms = cuda_ms(torch, lambda: fn(a, b, iters), reps)
        # one Montgomery product per column and step, in either radix
        b_ms, b_by = bound(3 * a.numel() * 4, MUL_OPS * n * iters)
        rows[name] = {
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": cuda_ms(torch, lambda: ub.mont_chain_plain(a, b, iters, bits), 1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "melem_per_s": n * iters / (ms / 1e3) / 1e6,
        }
    log("P1/P2: " + json.dumps(rows))
    bad = {k: r["max_abs_err"] for k, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise PhaseError(f"P1/P2 disagree with their plain versions: {bad}")
    return {"rows": rows, "probe_ms_per_iter": {k: v * 1e3 for k, v in probe_s.items()}}


def run(args) -> dict:
    import numpy as np
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is False")
    try:
        from nova_tpu_torch import _build, native
    except ImportError as exc:
        raise PhaseError(f"nova_tpu_torch is not importable: {exc}")
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.fields import kernels as fk
    from nova_tpu_torch.fields.spec import ALL_FIELDS, pallas_base, pallas_scalar
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops import msm2, msm3
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    dev = torch.device("cpu" if args.rehearse else "cuda")
    workers = max(1, min(8, os.cpu_count() or 1))
    log_n = REHEARSE_LOG_N if args.rehearse else LOG_N
    n = 1 << log_n
    # on CPU tensors the MSM caps the window at 9 (msm3._effective_window)
    c = 9 if args.rehearse else 16
    reps = 1 if args.rehearse else 5

    # -- phase 1: build -------------------------------------------------
    log(f"== phase 1: build ({torch.__version__}, CUDA {torch.version.cuda})")
    smi = "rehearsal on the CPU: no card"
    # the native host binding (g++) builds while nvcc builds the kernels
    with ThreadPoolExecutor(1) as ex:
        t0 = time.perf_counter()
        native_ok = ex.submit(lambda: (native.available(), time.perf_counter() - t0))
        if not args.rehearse:
            _build.lib()
            log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_info})")
        ok, native_s = native_ok.result()
    if not ok:
        raise PhaseError("the native host binding did not build (native/nova_native.cpp)")
    log(f"native host binding: built or found in {native_s:.1f} s")
    if not args.rehearse:
        with open(os.path.join(_build.build_info["dir"], "ptxas.log")) as fh:
            for line in fh:
                if "registers" in line or "spill" in line or line.startswith("=="):
                    log("ptxas: " + line.rstrip())
        smi = smi_line()
    log(f"card: {smi}")

    # -- phase 2: the main path -------------------------------------------
    log(f"== phase 2: main path (pallas, n = 2^{log_n}, window {c})")
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
    first_commit = dict(_build.LAUNCHES)  # includes the key's window precompute
    vs = [FVec.from_ints(pallas.scalar, s, device=dev) for s in batch]
    bcoms = CommitmentEngine.batch_commit(ck, vs, [0] * 4)
    com_small = CommitmentEngine.commit_small(ck, small)
    if not args.rehearse:
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    missing = [k for k in COMMIT_KERNELS if launches[k] == 0]
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
    # K1 in every field of fields/spec.py on 2^20 rows (2^12 in a rehearsal)
    # of full 16-bit limbs (most operands of the 254- and 255-bit fields lie
    # in [p, 2^256)), with edge values on both sides and a one-row operand on
    # either side (a constant, read once a block)
    m16 = rng.integers(0, 1 << 16, size=(1 << (12 if args.rehearse else 20), 2, 16),
                       dtype=np.int64)
    worst = 0
    for fname, spec_f in sorted(ALL_FIELDS.items()):
        tf = TField(spec_f)
        p = spec_f.p
        a = torch.from_numpy(m16[:, 0].astype(np.int32)).to(dev)
        b = torch.from_numpy(m16[:, 1].astype(np.int32)).to(dev)
        edge = torch.from_numpy(tf.pack([0, 1, p - 1, p - 2, p, p + 1, (1 << 256) - 1,
                                         (1 << 256) - 2, spec_f.r])).to(dev)
        a[: len(edge)] = edge
        b[16 : 16 + len(edge)] = edge
        top = edge[6]  # 2^256 - 1
        for x, y in ((a, b), (a, top), (top, b), (tf.const_mont(12345, b), b)):
            got = fk.mont_mul(tf, x, y)
            ref = tf.ops(dev).mul(x.long(), y.long()).expand(got.shape)
            worst = max(worst, int((got.long() - ref).abs().max().item()))
    errs["mont_mul"] = worst
    k1_in = (tf, a, b)  # the secp scalar field's, the last in the loop

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
    # K2 on random rows (field elements below 2^254, not curve points), a
    # third of each side's lanes the identity and some lanes both
    rnd = rng.integers(0, 1 << 16, size=(8, L, 16), dtype=np.int64)
    rnd[..., 15] &= 0x3FFF
    rnd = torch.from_numpy(rnd.astype(np.int32)).to(dev)
    RP, RQ = dict(zip(fk.KEYS, rnd[:4])), dict(zip(fk.KEYS, rnd[4:]))
    lane = torch.arange(L, device=dev)
    for side, r in ((RP, 0), (RQ, 1)):
        for k in ("zz", "zzz"):
            side[k][(lane % 3 == r) | (lane % 7 == 0)] = 0
    ref = fk.xyzz_add_limbs(o, tuple(RP[k].long() for k in fk.KEYS),
                            tuple(RQ[k].long() for k in fk.KEYS))
    errs["xyzz_add"] = max(errs["xyzz_add"],
                           max_abs_err(torch, fk.xyzz_add(bf, RP, RQ), dict(zip(fk.KEYS, ref))))
    # K3 with one and with c chained doublings (a window's) on those rows:
    # identity lanes (8-16, 32-40) and Y = 0 lanes (40-48), whose ZZ becomes
    # 0 at the first doubling, after which every step copies them
    D = {k: t.clone() for k, t in Q.items()}
    D["y"][40:48] = 0
    errs["xyzz_double"] = 0
    for times in (1, c):
        ref = fk.xyzz_double_limbs(o, tuple(D[k].long() for k in fk.KEYS), times)
        errs["xyzz_double"] = max(errs["xyzz_double"], max_abs_err(
            torch, fk.xyzz_double(bf, D, times), dict(zip(fk.KEYS, ref))))

    W = msm3._windows_for(c, pallas.scalar.p)
    sorted_d, st = msm3._prep_mont(db, v.m, c, W)
    R, C = st["grid"]
    nb = 1 << (c - 1)
    log(f"K4 grid: R = {R}, C = {C} (n_s = {R * C})")
    # level 1 (affine input read through the sort permutation) and level 2
    # (the carries, XYZZ input) on the commit's own sequence, in both modes
    k4_l1 = (bf, (R, C), sorted_d, st["pts"], "fast", nb, st["src"], st["signs"])
    tail1, colend, _ = msm3.accum(*k4_l1)
    C2 = max(128, C // msm3._R2)
    k4_l2 = (bf, (C // C2, C2), msm3._column_ends(sorted_d, R), colend, "fast", nb)
    acc_err, k4_rows = 0, {}
    for level, a in (("affine", k4_l1), ("xyzz", k4_l2)):
        for mode in ("fast", "complete"):
            args_m = a[:4] + (mode,) + a[5:]
            got, ref = msm3.accum(*args_m), msm3.accum_plain(*args_m)
            e = max(max_abs_err(torch, got[0], ref[0]), max_abs_err(torch, got[1], ref[1]),
                    int((got[2] - ref[2]).abs().max().item()))
            k4_rows[f"{level}/{mode}"] = {
                "grid": list(a[1]), "max_abs_err": e, "flagged_columns": int(got[2].sum()),
                "tails": int(got[0]["zz"].ne(0).any(-1).sum())}
            acc_err = max(acc_err, e)
    log("K4 against its plain version (tail table, colend, flag): " + json.dumps(k4_rows))
    errs["accum"] = acc_err
    # K2s, K5 and K2 on the inputs a commit gives them: the level-2 carries
    # (C2 = 4,096 at 2^16), the 2^15-bucket table and the 2^15-row adds of
    # _bucket_totals
    with largest_calls({"suffix_segmented": (msm3, "suffix_to_buckets"),
                        "bucket_reduce": (msm3, "_bucket_reduce"),
                        "xyzz_add": (fk, "xyzz_add")}) as seen3:
        CommitmentEngine.commit(ck, v)
    k2s_in, k5_in, k2_in = seen3["suffix_segmented"], seen3["bucket_reduce"], seen3["xyzz_add"]
    errs["suffix_segmented"] = kernel_vs_plain(torch, "suffix_segmented", k2s_in)
    errs["bucket_reduce"] = kernel_vs_plain(torch, "bucket_reduce", k5_in)
    errs["xyzz_add"] = max(errs["xyzz_add"], kernel_vs_plain(torch, "xyzz_add", k2_in))
    runs = torch.unique_consecutive(k2s_in[1].long())
    log(f"commit's bucket stage: K2s over {k2s_in[1].shape[0]} carries "
        f"({runs.numel()} runs), K5 over {k5_in[1]['x'].shape[0]} buckets, K2 on "
        f"{k2_in[1]['x'].shape[0]} rows")
    # K2s where digits repeat, so its backward walks, the segmented scan
    # over the slices and the joins all add: the commit's level-1 column
    # ends and carries, and a column of 4,096 of those carries whose digits
    # have runs of every length (one across a third of the slices) between
    # digit-0 rows and -1 padding
    m = min(4096, colend["x"].shape[0])
    d = np.sort(rng.integers(1, nb + 1, m))
    d[m // 5 : m // 5 + m // 3] = d[m // 5]
    d = np.sort(d)
    d[: m // 8] = 0
    d[m - m // 8 :] = -1
    spanning = (bf, torch.from_numpy(d.astype(np.int32)).to(dev),
                {k: t[:m] for k, t in colend.items()}, nb)
    for label, a in (("level-1 carries", (bf, msm3._column_ends(sorted_d, R), colend, nb)),
                     ("spanning runs", spanning)):
        e = kernel_vs_plain(torch, "suffix_segmented", a)
        digs = a[1].long()
        log(f"K2s on {label}: {digs.shape[0]} carries, "
            f"{torch.unique_consecutive(digs).numel()} runs, max |kernel - plain| {e}")
        errs["suffix_segmented"] = max(errs["suffix_segmented"], e)
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
    tf1, a, b = k1_in
    mont_n = a.shape[0]
    timed["mont_mul"] = (
        cuda_ms(torch, lambda: fk.mont_mul(tf1, a, b), reps),
        cuda_ms(torch, lambda: tf1.ops(dev).mul(a.long(), b.long()), max(1, reps // 2)),
        bound(3 * ROW * mont_n, MUL_OPS * mont_n),
    )
    # K1's device time (torch.profiler: every kernel a call launches, so a
    # copy of a broadcast operand would count) at its callers' shapes, and
    # the latency of one chained product, add and doubling (the probe)
    from nova_tpu_torch.perf import bucket_stage

    k1_shapes = {}
    shapes = bucket_stage.k1_shapes(torch, np, rng, sf, dev, 8 if args.rehearse else 0)
    for label, (x, y, nbytes) in shapes.items():
        rows_k1 = torch.broadcast_shapes(x.shape, y.shape).numel() // 16
        k1_shapes[label] = (device_ms(torch, lambda: fk.mont_mul(sf, x, y), reps),
                            bound(nbytes, MUL_OPS * rows_k1))
    chain = {} if args.rehearse else bucket_stage.chain_probe(torch, np, rng, bf, _build,
                                                         _build.lib())
    log("K1 at its callers' shapes (device ms, (bound ms, by)): " + json.dumps(k1_shapes))
    log("chained steps on one warp (us) and on the card (per us): " + json.dumps(chain))
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
    # K3 at the window precompute's shape: one launch of c chained
    # doublings of the key's bases
    KB = {"x": fx[:L], "y": fy[:L], "zz": one, "zzz": one}
    KBl = tuple(KB[k].long() for k in fk.KEYS)
    timed["xyzz_double"] = (
        cuda_ms(torch, lambda: fk.xyzz_double(bf, KB, c), reps),
        cuda_ms(torch, lambda: fk.xyzz_double_limbs(o, KBl, c), 1),
        double_bound(KB, c),
    )
    timed["accum"] = (
        cuda_ms(torch, lambda: msm3.accum(*k4_l1), reps),
        cuda_ms(torch, lambda: msm3.accum_plain(*k4_l1), 1),
        accum_bound(sorted_d, R, C, tail1),
    )
    table = k5_in[1]
    timed["bucket_reduce"] = (
        cuda_ms(torch, lambda: msm2._bucket_reduce(bf, table), reps),
        cuda_ms(torch, lambda: msm2.bucket_reduce_plain(bf, table), 1),
        bucket_reduce_bound(table["x"].shape[0]),
    )
    timed["suffix_segmented"] = (
        cuda_ms(torch, lambda: msm3.suffix_to_buckets(*k2s_in), reps),
        cuda_ms(torch, lambda: msm3.suffix_to_buckets_plain(*k2s_in), 1),
        suffix_bound(torch, k2s_in[1], nb),
    )
    # K2 and K3 at the shapes the main path launches them: K2 on the
    # 2^15-row adds of _bucket_totals, K3 on a window of the key's
    # precompute (2^16 rows, c doublings; phase 6 adds the witness key's),
    # and K2/K3 on one row (one add's and one doubling's latency)
    _, kp, kq = k2_in
    P1 = {k: t[40:41] for k, t in P.items()}
    Q1 = {k: t[40:41] for k, t in Q.items()}
    path_shapes = {
        "mont_mul": k1_shapes,
        "xyzz_add": {
            f"{kp['x'].shape[0]} rows": (cuda_ms(torch, lambda: fk.xyzz_add(bf, kp, kq), reps),
                                         add_bound(kp, kq, kp["x"].shape[0])),
            f"{kp['x'].shape[0]} rows, device ms": (
                device_ms(torch, lambda: fk.xyzz_add(bf, kp, kq), reps),
                add_bound(kp, kq, kp["x"].shape[0])),
            "1 row": (cuda_ms(torch, lambda: fk.xyzz_add(bf, P1, Q1), reps),
                      add_bound(P1, Q1, 1)),
        },
        "xyzz_double": {
            f"{L} rows x {c}, device ms": (
                device_ms(torch, lambda: fk.xyzz_double(bf, KB, c), reps), double_bound(KB, c)),
            "1 row": (cuda_ms(torch, lambda: fk.xyzz_double(bf, P1), reps),
                      bound(8 * ROW, MUL_OPS * 9)),
        },
    }
    log("K2/K3 at the path's shapes (ms, (bound ms, by)): " + json.dumps(
        {k: v for k, v in path_shapes.items() if k != "mont_mul"}))
    # the commit key's window precompute (K3 once a window, K1 in the
    # batched inversions), wall and device-busy
    precompute = {}
    if not args.rehearse:
        bx, by, binf = msm2._sized(db, n_pad)
        Wc = msm2._num_windows2(c)
        precompute["commit_key"] = precompute_ms(
            torch, lambda: msm2._precompute_shifted(bf, c, Wc, bx, by, binf))
        log("the commit key's window precompute: " + json.dumps(precompute["commit_key"]))

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
        "precompute_launches": {k: first_commit[k] - per_msm[k] for k in per_msm},
        "path_shapes": path_shapes, "chain": chain, "precompute_ms": precompute,
    }
    log("msm3m: " + json.dumps(msm))
    if args.profile:
        profile_window(torch, lambda: CommitmentEngine.commit(ck, v), reps, "commits")

    fold = fold_step(args, torch, dev, workers, ck, scal)
    comp = compress(args, torch, dev, fold["pp"], fold["rs"])
    kzg = kzg_path(args, torch, dev, workers)
    spark = ppsnark_path(args, torch, dev, workers, kzg)
    direct = direct_path(args, torch, dev)
    sha = sha256_path(args, torch, dev, workers)
    neutron = neutron_path(args, torch, dev)
    as_bytes = bytes_path(args, torch, fold, comp, sha.pop("pp"))
    mesh = mesh_path(args, torch, dev, ck, v, com.point, fold)
    entry = entry_path(args, torch, dev)
    ubench = field_ubench(args, torch, dev)
    log("compression: " + json.dumps({k: v for k, v in comp.items()
                                      if k not in ("snark", "vk")}))
    log("KZG path: " + json.dumps({k: v for k, v in kzg.items() if k not in ("pp", "ptau_dir")}))
    log("ppsnark path: " + json.dumps(spark))
    log("DirectSNARK: " + json.dumps(direct))
    log("SHA-256 path: " + json.dumps(sha))
    log("Neutron path: " + json.dumps(neutron))
    log("bytes: " + json.dumps(as_bytes))
    log("mesh: " + json.dumps({k: v for k, v in mesh.items() if k != "step"}))
    log("entry points: " + json.dumps(entry))
    log("field microbenchmark: " + json.dumps(ubench))
    if not args.rehearse:
        # the bucket stage's contract: no K3 per call on any path (K3 runs
        # only in a key's window precompute), K2 twice per commit (the two
        # 2^15-row adds of _bucket_totals), one K5 and one K2s per commit
        per_call = {"commit": msm["launches_per_msm"],
                    "msm_device2": fold["msm_device2_launches"],
                    "compression": comp["launches"],
                    "kzg_compression": kzg["compress_launches"]}
        for i, sl in enumerate(fold["fold"]["launches_per_replayed_step"]):
            per_call[f"replayed prove_step {i + 1}"] = sl
        for i, sl in enumerate(kzg["launches_per_replayed_step"]):
            per_call[f"replayed KZG prove_step {i + 1}"] = sl
        for i, sl in enumerate(sha["launches_per_replayed_step"]):
            per_call[f"replayed SHA-256 prove_step {i + 1}"] = sl
        per_call["sharded MSM"] = mesh["launches"]["sharded_msm"]
        per_call["replayed meshed prove_step"] = mesh["launches"]["meshed_step"]
        k3 = {k: v["xyzz_double"] for k, v in per_call.items() if v["xyzz_double"]}
        if k3:
            raise PhaseError(f"K3 launched per call (0 expected on every path): {k3}")
        # and once a window in a key's precompute: 16 windows after the
        # first at the commit key's c = 16, 19 at the witness key's c = 14
        k3_pre = {"commit_key": msm["precompute_launches"]["xyzz_double"],
                  "witness_key": fold["witness_precompute_launches"]["xyzz_double"]}
        want_pre = {"commit_key": msm2._num_windows2(c) - 1,
                    "witness_key": msm2._num_windows2(fold["witness_window"]) - 1}
        if k3_pre != want_pre:
            raise PhaseError(f"K3 launches in the window precompute {k3_pre}, "
                             f"expected one a window {want_pre}")
        commit = msm["launches_per_msm"]
        want = {"xyzz_add": COMMIT_XYZZ_ADDS, "bucket_reduce": 1, "suffix_segmented": 1}
        if any(commit[k] != v for k, v in want.items()):
            raise PhaseError(f"launches per commit {commit}, expected {want}")
    log(f"== done: all phases passed")
    log("phase wall times (s): " + json.dumps(phase_walls()))

    rows = []
    for name in REPLACES:
        if name == "stage":
            row = dict(fold["row"])
            row["max_abs_err"] = max(row["max_abs_err"], kzg["kernel_errs"]["stage"],
                                     spark["kernel_errs"].get("stage", 0),
                                     sha["kernel_errs"]["stage"],
                                     neutron["kernel_errs"]["stage"],
                                     entry["kernel_errs"].get("stage", 0))
        elif name in UBENCH_KERNELS:
            row = {k: ubench["rows"][name][k] for k in
                   ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_share")}
        else:
            ms, plain_ms, (b_ms, b_by) = timed[name]
            err = max(errs.get(name, 0), fold["kernel_errs"].get(name, 0),
                      kzg["kernel_errs"].get(name, 0), spark["kernel_errs"].get(name, 0),
                      sha["kernel_errs"].get(name, 0), mesh["kernel_errs"].get(name, 0),
                      entry["kernel_errs"].get(name, 0),
                      comp["k1_err"] if name == "mont_mul" else 0,
                      comp["k5_err"] if name == "bucket_reduce" else 0)
            row = {"launches": launches[name], "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
            if name == "bucket_reduce":
                d2 = fold["k5_msm_device2"]
                row["msm_device2"] = {"buckets": d2["buckets"], "ms": d2["ms"],
                                      "plain_ms": d2["plain_ms"], "bound_ms": d2["bound"][0]}
            if name == "mont_mul":
                row["chain"] = msm["chain"]
            if name in msm["path_shapes"]:
                shapes = dict(msm["path_shapes"][name])
                if name == "xyzz_double":
                    shapes.update(fold["k3_window"])
                    row["precompute_ms"] = {"commit_key": msm["precompute_ms"].get("commit_key"),
                                            "witness_key": fold["witness_precompute_ms"]}
                row["path_shape_ms"] = {
                    shape: {"ms": t, "bound_ms": b[0], "bound_by": b[1]}
                    for shape, (t, b) in shapes.items()}
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], **row, "library_ms": None,
            "fold_step_launches": fold["fold_launches"][name],
            "compress_launches": comp["launches"][name],
            "launches_per_call": {
                "commit": msm["launches_per_msm"][name],
                "prove_step": [sl[name] for sl in fold["fold"]["launches_per_replayed_step"]],
                "msm_device2": fold["msm_device2_launches"][name],
                "compression": comp["launches"][name],
                "kzg_prove_step": [sl[name] for sl in kzg["launches_per_replayed_step"]],
                "kzg_compression": kzg["compress_launches"][name],
            },
            "kzg_path_launches": kzg["launches"][name],
            "mercury_compress_launches": kzg["mercury"]["launches"][name],
            "pp_path_launches": spark["launches"][name],
            "pp_compress_launches": spark["compress_launches"][name],
            "direct_launches": direct["launches"][name],
            "sha256_path_launches": sha["launches"][name],
            "sha256_replayed_step_launches": [sl[name] for sl in
                                              sha["launches_per_replayed_step"]],
            "neutron_path_launches": neutron["launches"][name],
            "neutron_step_launches": [sl[name] for sl in neutron["launches_per_step"]],
            "mesh_launches": {part: ls[name] for part, ls in mesh["launches"].items()},
            "mesh_shape_ms": mesh["shape_ms"].get(name),
            "entry_launches": {
                "msm1": entry["launches"]["msm1"][name],
                "minroot": entry["launches"]["minroot"][name],
                "minroot_steps": [sl[name] for sl in entry["launches"]["minroot_steps"]],
                "minroot_compression": entry["launches"]["minroot_compression"][name],
            },
            "minroot_shape_ms": entry["shape_ms"].get(name),
            "precompute_launches": {
                "commit_key": msm["precompute_launches"][name],
                "witness_key": fold["witness_precompute_launches"][name],
            },
        })
        if spark["timing"]:
            rows[-1]["precompute_launches"]["spark_key"] = (
                spark["timing"]["precompute_launches"][name])
        for key, src in (("kzg_shape_ms", kzg), ("pp_shape_ms", spark),
                         ("sha256_shape_ms", sha)):
            if name in src["shape_ms"]:
                rows[-1][key] = src["shape_ms"][name]
    return {"smi": smi, "kernels": rows, "msm": msm}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over sequential commits "
                         "and over replayed prove_steps")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU with the plain versions at 2^10 / "
                         "2^14 (no card, no result line)")
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
