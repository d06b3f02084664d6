"""Harness: points committed over the traced part of the window, to set
beside commit_pts_per_s and idle_pct.commit: how far tracing slows the
host that paces the cell."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or "portbench:commit" not in t["span_device_s"]:
        return None
    return t["span_device_s"]["portbench:commit"][1] * ctx["points"] / t["window_s"]
