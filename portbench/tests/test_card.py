"""On the card, at each cell's own size: a sound run is correct and the
control (commitments of 128-bit truncations) is not. Skips without a card.

    python -m pytest portbench/tests/test_card.py"""

import json

import pytest

import run
from benchlib import spec
from benchlib.faults import FAULTS
from conftest import ROOT

pytestmark = pytest.mark.card


def _cells():
    with open(f"{ROOT}/BENCHMARK.json") as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.parametrize("name", _cells())
@pytest.mark.parametrize("fault", [None, "truncated"])
def test_cell_on_card(card, name, fault):
    res = run.run_cell(spec.cell(name), 2**31 + 31337, 5.0, False, card, FAULTS.get(fault))
    assert res["correct"] is (fault is None), res["checks"]
