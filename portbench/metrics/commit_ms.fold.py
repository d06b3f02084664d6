"""Pedersen/MSM: the witness commitments of both circuits a step."""
from benchlib.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("commit_primary", "commit_secondary"))
