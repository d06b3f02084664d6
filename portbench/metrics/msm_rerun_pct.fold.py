"""Pedersen/MSM: the share of the window's fixed-base MSM calls (the
witness and cross-term commitments) rerun with complete formulas after a
degenerate fast add (the program's counters ``msm.reruns``, ``msm.calls``)."""
from benchlib.counters import rerun_pct


def read(ctx):
    return rerun_pct()
