"""Prune a full PPOT ceremony file to header + 2^power + 1 G1 + 2 G2 points
(~18x smaller; the twin of ``examples/ppot_prune.py``; reference
examples/ppot_prune.rs).

    python -m nova_tpu_torch.examples.ppot_prune <src.ptau> <power> [output_dir]

Writes ``ppot_pruned_<power>.ptau``. The work is file I/O on the host:
the script uses no device, so it neither asks for the card nor takes a
``device``."""

from __future__ import annotations

import os
import sys


def main(argv=None) -> str:
    """Prune; returns the pruned file's path (exits with the usage text
    when the arguments are missing)."""
    from nova_tpu_torch.provider import ptau

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        sys.exit(1)
    src = argv[0]
    power = int(argv[1])
    out_dir = argv[2] if len(argv) > 2 else "."
    dst = os.path.join(out_dir, f"ppot_pruned_{power:02d}.ptau")
    print(f"pruning {src} -> {dst} (power {power}) ...")
    ptau.prune_ptau(src, dst, power)
    print(f"ok: {os.path.getsize(dst)} bytes")
    return dst


if __name__ == "__main__":
    main()
