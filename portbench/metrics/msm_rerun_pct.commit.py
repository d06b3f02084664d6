"""Pedersen/MSM: the share of fixed-base MSM chunks (four a 2^20 commit)
rerun with complete formulas after a degenerate fast add (the program's
counters ``msm.reruns``, ``msm.calls``), over the run's commits, set-up's
warm ones included."""
from benchlib.counters import rerun_pct


def read(ctx):
    return rerun_pct()
