"""NIFS: the fold of both instances a step (cross-term, its commitment,
the fold of vectors and commitments)."""
from benchlib.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("nifs_primary", "nifs_secondary"))
