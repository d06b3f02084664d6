"""Kind "commit": CommitmentEngine.commit of device vectors of
2^log_points scalars back to back, one caller, each point read on the host.
A pool of `pool` distinct vectors, made on the card from the seed, is used
in turn. Each scalar is drawn uniformly below 2^scalar_bits (1 gives 0/1
scalars), which must be under the scalar field's width. After the window
the reference judges every commitment of it at once."""

import math
import time
from typing import List

from benchlib.kit import Outcome, failed, free, peak, point, sync, window
from benchlib.spec import Cell


def _limb_masks(bits: int) -> List[int]:
    """The 16 sixteen-bit limbs' masks of a scalar below 2^bits."""
    return [(1 << max(0, min(16, bits - 16 * k))) - 1 for k in range(16)]


def run(cell: Cell, seed: int, seconds: float, tracer, dev, fault=None) -> Outcome:
    import torch

    from nova_tpu_torch.curves.spec import ALL_CURVES
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.ops.fvec import FVec
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    cfg, tr = cell.config, cell.traffic
    curve = ALL_CURVES[cfg["commit_curve"]]
    key = cfg["primary_key"]
    n, bits, pool_size = 1 << tr["log_points"], tr["scalar_bits"], tr["pool"]
    if not 1 <= bits < curve.scalar.p.bit_length():
        raise ValueError(f"scalar_bits {bits} is not under the scalar field's width")
    ck = CommitmentEngine.setup(curve, key["label"].encode(), n, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (pool_size, n, 16), dtype=torch.int32,
                          device=dev, generator=gen)
    limbs &= torch.tensor(_limb_masks(bits), dtype=torch.int32, device=dev)
    tf = TField(curve.scalar)
    pool = [FVec(tf, tf.to_mont(limbs[j])) for j in range(pool_size)]
    for v in pool:
        CommitmentEngine.commit(ck, v)
    sync(torch, dev)
    lat: List[float] = []
    done, error = [], None
    with window(tracer, fault):
        t0 = time.perf_counter()
        while True:
            j = len(done) % pool_size
            t = time.perf_counter()
            try:
                with tracer.span("portbench:commit"):
                    C = CommitmentEngine.commit(ck, pool[j])
            except Exception as e:  # a failed call ends the window
                error = e
                break
            lat.append(time.perf_counter() - t)
            done.append((j, point(C)))
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    mem = peak(torch, dev)
    raw = limbs.cpu().numpy().astype("<u2")
    del pool, ck, limbs
    free(torch, dev)
    ints = [[int.from_bytes(row.tobytes(), "little") for row in raw[j]] for j in range(pool_size)]
    lat.sort()

    from pbref.checks import commit_checks

    k = len(done)
    return Outcome(
        window_start=t0, window_s=t1 - t0, attempted=k + (error is not None),
        failed=int(error is not None),
        end_to_end={"commit_pts_per_s": k * n / (t1 - t0),
                    "commit_p95_ms": lat[max(math.ceil(0.95 * k) - 1, 0)] * 1e3 if k else 0.0},
        ctx={"commits": k, "points": n, "scalar_bits": bits, "trace": tracer.result},
        memory_peak_bytes=mem,
        check=(failed(error) if error else
               lambda: commit_checks(cfg["commit_curve"], key, ints, done, seed)),
        info={"commits": k})
