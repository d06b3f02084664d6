"""Generate an INSECURE test Powers-of-Tau file (the twin of
``examples/ptau_test_setup.py``; reference examples/ptau_test_setup.rs).

    python -m nova_tpu_torch.examples.ptau_test_setup <power> [output_dir]

Writes ``ppot_pruned_<power>.ptau`` (2^power + 1 G1 powers of a random
tau, by the native host binding's fixed-base multiply, and 2 G2 points) and
checks that it reads back. The work is on the host (the native binding
and file I/O): the script uses no device, so it neither asks for the card
nor takes a ``device``."""

from __future__ import annotations

import os
import secrets
import sys


def main(argv=None) -> str:
    """Write the file; returns its path."""
    from nova_tpu_torch.curves.spec import bn254
    from nova_tpu_torch.provider import ptau

    argv = sys.argv[1:] if argv is None else argv
    power = int(argv[0]) if len(argv) > 0 else 10
    out_dir = argv[1] if len(argv) > 1 else "."
    path = os.path.join(out_dir, f"ppot_pruned_{power:02d}.ptau")
    tau = secrets.randbelow(bn254.scalar.p)
    print(f"writing INSECURE test SRS (power {power}) to {path} ...")
    ptau.write_test_ptau(path, tau, power)
    ptau.check_sanity_of_ptau_file(path, (1 << power), 2)
    print(f"ok: {os.path.getsize(path)} bytes")
    return path


if __name__ == "__main__":
    main()
