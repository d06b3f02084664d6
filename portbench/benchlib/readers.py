"""What the per-layer readers share. A reader gets ctx: the window's
length and, per kind, its steps and the prover's phase totals (NOVA_PROFILE)
or its commits, points and scalar width; and the reduced trace (None when
no trace was read). A reader that finds nothing returns None."""

from __future__ import annotations


def phase_ms(ctx: dict, names) -> float:
    """Milliseconds a step in the prover's phases `names`, summed."""
    ph, steps = ctx.get("phases_s") or {}, ctx.get("steps")
    if not steps or not any(n in ph for n in names):
        return None
    return sum(ph.get(n, 0.0) for n in names) / steps * 1e3


def idle_pct(ctx: dict) -> float:
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def span_device_ms(ctx: dict, span: str) -> float:
    """Device milliseconds of the kernels inside one `span`, a span."""
    t = ctx.get("trace")
    if not t or span not in t["span_device_s"]:
        return None
    total, count = t["span_device_s"][span]
    return total / count * 1e3 if count and total > 0 else None
