"""IVC: field elements converted between Python int lists and device
tensors a step, both ways (the program's counters ``conv.to_device`` and
``conv.to_host``). The count includes the harness's one read of the last
running witness after the window (its W and E), spread over the steps."""
from benchlib.counters import per_step


def read(ctx):
    return per_step(ctx, ("conv.to_device", "conv.to_host"))
