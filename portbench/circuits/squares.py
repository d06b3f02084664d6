"""The step circuit "squares": the program's NonTrivialCircuit, z -> z^2
repeated, one constraint a squaring, as many as pad the primary to
2^pad_log_cons constraints. The reference's side is pbref/steps/squares.py.

Traffic: "circuit": "squares", "circuit_args": {"pad_log_cons": k}."""

import random


def build(args: dict, base_rows: int):
    """(the step circuit, the parameters the reference is given, the
    primary's constraint count); `base_rows` is the primary's count with a
    step circuit of no constraints."""
    from nova_tpu_torch.nova.circuit import NonTrivialCircuit

    rows = 1 << args["pad_log_cons"]
    squares = rows - base_rows
    return NonTrivialCircuit(squares), {"squares": squares}, rows


def z0(args: dict, seed: int, p: int) -> list:
    return [random.Random(seed).randrange(p)]
