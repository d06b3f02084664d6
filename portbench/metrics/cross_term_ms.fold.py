"""NIFS: the cross-term T of both folds a step, up to T and without its
commitment (the program's span ``nifs.cross_term``, inside ``nifs_*``)."""
from benchlib.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("nifs.cross_term",))
