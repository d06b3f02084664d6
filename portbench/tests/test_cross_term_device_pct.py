"""The reader of ``cross_term_device_pct.fold`` on hand-made counters: 100 x
device rows / all rows, and None where the program keeps neither counter
(as a program without them does)."""

import pytest

from benchlib.spec import load_reader

NAME = "cross_term_device_pct.fold"


@pytest.mark.parametrize("c,want", [
    ({"nifs.cross_term_rows.device": 131_072, "nifs.cross_term_rows.host": 10_349},
     100.0 * 131_072 / 141_421),
    ({"nifs.cross_term_rows.device": 64}, 100.0),
    ({"nifs.cross_term_rows.host": 64, "conv.to_device": 9}, 0.0),
    ({"conv.to_device": 9}, None),
    ({}, None),
])
def test_reads_the_device_share_of_the_rows(monkeypatch, c, want):
    from nova_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(c))
    assert load_reader(NAME)({"steps": 4}) == want


def test_reads_nothing_in_a_program_without_counters(monkeypatch):
    from nova_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_reader(NAME)({"steps": 4}) is None
