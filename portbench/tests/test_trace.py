"""The trace's reduction: busy time as a union inside the window, device
time inside each span, idle gaps split over the innermost spans, and the
host's clock placed on the trace's by the two marker kernels."""

import pytest

from benchlib.trace import markers, place, reduce_events


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_events():
    ev = [_x("kernel", "k1", 25, 5),
          _x("kernel", "k1", 27, 2),  # overlaps the first: counted once in busy
          _x("gpu_memcpy", "copy", 60, 10),
          _x("kernel", "late", 95, 20),  # clipped at the window's end
          _x("cpu_op", "aten::add", 40, 5),  # host work is not device time
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1}]
    r = reduce_events(ev, (0, 100), [(10, 90, "step"), (20, 50, "inner")])
    us = 1e-6
    assert abs(r["window_s"] - 100 * us) < 1e-12
    assert abs(r["busy_s"] - 20 * us) < 1e-12
    assert r["span_device_s"]["inner"][1] == 1
    assert abs(r["span_device_s"]["inner"][0] - 5 * us) < 1e-12
    assert abs(r["span_device_s"]["step"][0] - 5 * us) < 1e-12  # kernels only, not copies
    gaps = dict(r["breakdown"]["idle_gaps"])
    # idle: [0,25) host 10, step 10, inner 5; [30,60) inner 20, step 10; [70,95) step 20, host 5
    assert {k: round(v / us, 6) for k, v in gaps.items()} == {"step": 40, "inner": 25, "host": 15}
    ops = dict(r["breakdown"]["device_ops"])
    assert round(ops["copy"] / us, 6) == 10 and round(ops["late"] / us, 6) == 5


SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


@pytest.mark.parametrize("lost", [None, 0, 3])
def test_markers_place_the_host_clock_on_the_trace(lost):
    """Two markers before the window, two after: the window lies between the
    second and the third, whichever of the outer ones the trace lost."""
    spins = [_x("kernel", SPIN, 4000.0, 2), _x("kernel", SPIN, 5000.0, 2),
             _x("kernel", SPIN, 55000.0, 2), _x("kernel", SPIN, 55100.0, 2)]
    if lost is not None:
        del spins[lost]
    ev = spins + [_x("kernel", "k", 6000.0, 3), _x("kernel", "k", 9000.0, 3)]
    assert len(markers(ev)) == (4 if lost is None else 3)
    host = (1_000_000_000, 1_050_000_000)
    window, to_us = place(ev, host, (1_000_010_000, 1_049_990_000))
    assert window == (5002.0, 55000.0)
    assert to_us(host[0]) == 5000.0
    assert abs(to_us(1_001_000_000) - 6000.0) < 1e-9


def test_one_marker_places_the_window_by_the_host_clock():
    ev = [_x("kernel", SPIN, 5000.0, 2), _x("kernel", "k", 6000.0, 3)]
    window, to_us = place(ev, (1_000_000_000, 1_050_000_000), (1_000_010_000, 1_030_000_000))
    assert window == (5002.0, 35000.0)
    with pytest.raises(RuntimeError):
        place([_x("kernel", "k", 6000.0, 3)], (0, 1), (0, 1))


def test_traced_rate_counts_the_commits_inside_the_trace():
    from benchlib.spec import load_reader

    read = load_reader("traced_pts_per_s.commit")
    ev = [_x("kernel", "k", 10, 5), _x("kernel", "k", 40, 5)]
    trace = reduce_events(ev, (0, 100), [(5, 30, "portbench:commit"), (35, 60, "portbench:commit")])
    assert read({"trace": trace, "points": 8}) == 2 * 8 / (100 * 1e-6)
    assert read({"trace": None, "points": 8}) is None
