"""Device: the share of the traced window in which no operation ran."""
from benchlib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
