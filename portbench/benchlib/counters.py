"""The program's counters (``nova_tpu_torch.profiling.counters()``), read
by the per-layer readers after the window. They count while tracing is on:
in a fold cell from the window's start (the kind resets the program's
totals there), in the commit cell from the process's start. A program
without counters gives None, and so does every reader below."""

from __future__ import annotations


def program_counters() -> dict:
    """The counters, or None where the program keeps none. Imported here,
    never when a reader is loaded: the program reads NOVA_PROFILE when it is
    first imported, which the harness sets only for a traced run."""
    from nova_tpu_torch import profiling

    get = getattr(profiling, "counters", None)
    return get() if get is not None else None


def per_step(ctx: dict, names) -> float:
    """The counters `names`, summed, over the window's steps."""
    c, steps = program_counters(), ctx.get("steps")
    if c is None or not steps or not any(n in c for n in names):
        return None
    return sum(c.get(n, 0) for n in names) / steps


def rerun_pct() -> float:
    """100 complete-mode reruns over fixed-base MSM calls."""
    c = program_counters()
    if not c or not c.get("msm.calls"):
        return None
    return 100.0 * c.get("msm.reruns", 0) / c["msm.calls"]
