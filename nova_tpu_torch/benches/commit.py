"""Commitment/MSM grid (the twin of ``benches/commit.py``; reference
benches/commit.rs:24-80): sizes 2^16-2^20 by default x scalar widths {1,
10, 16, 32, 64, 256} bits, on the card.

    python -m nova_tpu_torch.benches.commit [--sizes 16,18,20] [--quick]

The key is the JAX bench's: from_label(pallas, b"bench-commit", 2^max + 1),
the first generator the blinding one. CommitmentEngine.setup derives that
same list and keeps it in the port's key cache, so a later run loads it."""

from __future__ import annotations

from nova_tpu_torch._env import entry_device
from nova_tpu_torch.benches.common import emit, parse_args, rng, timeit

WIDTHS = (1, 10, 16, 32, 64, 256)


def main(argv=None, device=None) -> list:
    """Run the grid on `device` (the card unless "cpu"); returns the rows
    printed, each with its commitment's coordinates added."""
    from nova_tpu_torch.curves.spec import pallas
    from nova_tpu_torch.provider.pedersen import CommitmentEngine

    sizes, _ = parse_args([16, 18, 20], argv)
    dev = entry_device(device)
    ck = CommitmentEngine.setup(pallas, b"bench-commit", 1 << max(sizes), device=dev)
    r = rng()
    rows = []
    for lg in sizes:
        n = 1 << lg
        for bits in WIDTHS:
            bound = pallas.scalar.p if bits == 256 else (1 << bits)
            v = [r.randrange(bound) for _ in range(n)]
            comm = CommitmentEngine.commit(ck, v, 0)  # warm
            dt = timeit(lambda: CommitmentEngine.commit(ck, v, 0))
            row = emit("commit", f"2^{lg}/u{bits}", dt, {"points_per_sec": round(n / dt)})
            rows.append({**row, "commitment": comm.to_coordinates()})
    return rows


if __name__ == "__main__":
    main()
