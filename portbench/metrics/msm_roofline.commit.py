"""Kernels: the least time of an MSM of the cell's size (benchlib.roofline)
over the device time a commit took, in percent."""
from benchlib.readers import span_device_ms
from benchlib.roofline import msm_least_s


def read(ctx):
    busy = span_device_ms(ctx, "portbench:commit")
    if busy is None:
        return None
    return 100.0 * msm_least_s(ctx["points"], ctx["scalar_bits"]) * 1e3 / busy
