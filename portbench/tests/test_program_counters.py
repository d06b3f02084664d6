"""The readers of the program's own spans and counters
(``nova_tpu_torch.profiling``) on hand-made contexts: each reads its value,
and None where the program keeps no such span or counter, as a program
without them does. And the trace's reduction, given the program's nested
spans beside the harness's, splits the idle gaps over the innermost one."""

import pytest

from benchlib.spec import load_reader
from benchlib.trace import reduce_events


@pytest.fixture
def counters(monkeypatch):
    """Sets the program's counters to a given dict."""
    from nova_tpu_torch import profiling

    def put(c):
        monkeypatch.setattr(profiling, "counters", lambda: dict(c))

    return put


FOLD = {"conv.to_device": 3_000, "conv.to_host": 5_000, "msm.calls": 8, "msm.reruns": 2}


@pytest.mark.parametrize("name,ctx,want", [
    ("cross_term_ms.fold", {"steps": 4, "phases_s": {"nifs.cross_term": 2.0}}, 500.0),
    ("host_ints.fold", {"steps": 4}, 2_000.0),
    ("msm_rerun_pct.fold", {"steps": 4}, 25.0),
    ("msm_rerun_pct.commit", {"commits": 2, "points": 8}, 25.0),
])
def test_readers_read_the_program(counters, name, ctx, want):
    counters(FOLD)
    assert load_reader(name)(ctx) == want


@pytest.mark.parametrize("name,ctx", [
    ("cross_term_ms.fold", {"steps": 4, "phases_s": {"nifs_primary": 2.0}}),
    ("cross_term_ms.fold", {"steps": 0, "phases_s": {"nifs.cross_term": 2.0}}),
    ("host_ints.fold", {"steps": 4}),
    ("msm_rerun_pct.fold", {"steps": 4}),
    ("msm_rerun_pct.commit", {"commits": 2, "points": 8}),
])
def test_readers_find_nothing_in_a_program_without_them(monkeypatch, name, ctx):
    from nova_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_reader(name)(ctx) is None


def test_no_reruns_read_zero_and_no_calls_nothing(counters):
    counters({"msm.calls": 40})
    assert load_reader("msm_rerun_pct.fold")({"steps": 20}) == 0.0
    counters({"conv.to_host": 1})
    assert load_reader("msm_rerun_pct.commit")({}) is None


def test_idle_gaps_fall_to_the_innermost_program_span():
    """A step (harness) holding nifs_primary > nifs.cross_term > spmv
    (program); kernels at [20, 30) and [60, 70) in a window [0, 100)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 10}]
    spans = [(5, 95, "portbench:prove_step"), (10, 80, "nifs_primary"),
             (15, 50, "nifs.cross_term"), (35, 45, "spmv")]
    r = reduce_events(ev, (0, 100), spans)
    gaps = {k: round(v * 1e6, 6) for k, v in r["breakdown"]["idle_gaps"]}
    # [0,20): host 5, step 5, nifs 5, cross 5; [30,60): cross 5+5, spmv 10,
    # nifs 10; [70,100): nifs 10, step 15, host 5
    assert gaps == {"host": 10, "portbench:prove_step": 20, "nifs_primary": 25,
                    "nifs.cross_term": 15, "spmv": 10}
    assert r["span_device_s"]["spmv"] == (0.0, 1)
