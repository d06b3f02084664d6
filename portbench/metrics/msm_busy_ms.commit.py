"""Pedersen/MSM: device time a commit, every kernel that ran inside the
commit's span whatever its name."""
from benchlib.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "portbench:commit")
