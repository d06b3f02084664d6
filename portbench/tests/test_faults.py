"""The rest of a run with the card check skipped (on the CPU, at a small
size): sound runs are correct, and the control and every fault the cell can
have come out not correct. A fault is planted for the window only."""

import pytest
import torch

import run
from benchlib import spec
from benchlib.faults import FAULTS

SEED = 2**31 + 4242


def _fold():
    c = spec.cell("pallas-ipa.fold-2e17")
    c.traffic.update(circuit_args={"pad_log_cons": 14}, warm_steps=3)
    return c


def _commit():
    c = spec.cell("pallas-ipa.commit-2e20")
    c.traffic.update(log_points=6, pool=2)
    return c


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [None, "truncated", "state_unchanged", "witness_altered"])
def test_fold_cell(fault):
    res = run.run_cell(_fold(), SEED, 0.5, False, torch.device("cpu"), FAULTS.get(fault))
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is (fault is None), checks
    assert set(res["metrics"]) == {"step_s", "setup_s"}


@pytest.mark.parametrize("fault", [None, "truncated", "half_batch", "point_altered"])
def test_commit_cell(fault):
    res = run.run_cell(_commit(), SEED, 0.5, False, torch.device("cpu"), FAULTS.get(fault))
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is (fault is None), checks
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"commit_pts_per_s", "commit_p95_ms", "setup_s"}


@pytest.mark.parametrize("bits", [1, 128])
def test_commit_cell_scalar_widths(bits):
    """A traffic file states the scalars' width; 1 gives 0/1 scalars."""
    c = _commit()
    c.traffic.update(scalar_bits=bits)
    res = run.run_cell(c, SEED + bits, 0.5, False, torch.device("cpu"))
    assert res["correct"] is True, res["checks"]
