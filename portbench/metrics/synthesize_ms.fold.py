"""IVC: the host's witness synthesis (tape replay) a step, both circuits."""
from benchlib.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, ("synthesize_primary", "synthesize_secondary"))
