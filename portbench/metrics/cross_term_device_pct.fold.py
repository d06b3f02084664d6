"""NIFS: the share of the rows folded in the window whose cross-term T was
computed on the device, 100 x device rows / all rows (the program's counters
``nifs.cross_term_rows.device`` and ``nifs.cross_term_rows.host``, one count
of the shape's rows a fold). A program without them gives None."""
from benchlib.counters import program_counters

DEVICE, HOST = "nifs.cross_term_rows.device", "nifs.cross_term_rows.host"


def read(ctx):
    c = program_counters()
    if not c or (DEVICE not in c and HOST not in c):
        return None
    rows = c.get(DEVICE, 0) + c.get(HOST, 0)
    return 100.0 * c.get(DEVICE, 0) / rows if rows else None
