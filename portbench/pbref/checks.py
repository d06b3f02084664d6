"""The comparisons that decide a run's `correct`. Each takes plain data that
the harness read from the program's outputs (integers, lists, (x, y) pairs)
and the inputs the harness made, and returns {name: number}; every number
is a count of disagreements, so each limit is 0.

A commitment key is described by the configuration, never taken from the
program: {"kind": "pedersen", "label": ...} derives the generators again
from the label (the first one blinds); {"kind": "ptau", "tau": ...} is the
powers of tau on BN254's generator, blinded by the first generator of
label "h"."""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

from pbref import h2c, steps
from pbref.curves import CURVES, Point, add, combine, mul
from pbref.msm import msm_rows
from pbref.r1cs import unsat_rows


def _rho(seed: int, salt: int, r: int) -> int:
    """A 128-bit combination coefficient drawn from the run's seed."""
    return random.Random(seed * 1000003 + salt).getrandbits(128) % r


def commit_ref(curve_name: str, key: dict, v: Sequence[int], blind: int,
               workers: int = None) -> Point:
    """sum v_i G_i + blind * H under `key`."""
    curve = CURVES[curve_name]
    r = curve.r
    if key["kind"] == "ptau":
        acc = 0
        for x in reversed(v):
            acc = (acc * key["tau"] + x) % r
        h = h2c.from_rows(h2c.key_rows("bn254", b"h", 1))[0]
        return combine(curve, [(acc, curve.gen), (blind, h)])
    rows = h2c.key_rows(curve_name, key["label"].encode(), len(v) + 1, workers)
    h = h2c.from_rows(rows[:1])[0]
    return add(curve, msm_rows(curve_name, rows[1:], v, workers), mul(curve, h, blind))


def _combined(curve_name: str, key: dict, parts, seed: int, salt: int,
              workers: int = None) -> int:
    """1 if sum rho_j C_j differs from commit(sum rho_j v_j, sum rho_j b_j)
    over parts (C_j, v_j, b_j) with rho_0 = 1, else 0."""
    curve = CURVES[curve_name]
    r = curve.r
    n = max(len(v) for _, v, _ in parts)
    vec = [0] * n
    blind = 0
    lhs = []
    for j, (C, v, b) in enumerate(parts):
        rho = 1 if j == 0 else _rho(seed, salt + j, r)
        for i, x in enumerate(v):
            if x:
                vec[i] = (vec[i] + rho * x) % r
        blind = (blind + rho * b) % r
        lhs.append((rho, C))
    return int(combine(curve, lhs) != commit_ref(curve_name, key, vec, blind, workers))


def fold_checks(state: dict, seed: int, workers: int = None) -> Dict[str, int]:
    """The IVC state after the window against the plain reference.

    state: circuit (the step circuit's name, pbref/steps/<name>.py), params
    (what it was built with), z0, calls (prove_step calls made), zi; and
    "primary", "secondary", each {curve, key, p, shape: {A, B, C}, U:
    {comm_W, comm_E, X, u}, W: {W, r_W, E, r_E}}; the secondary also
    "last": {U: {comm_W, X}, W: {W, r_W}}, its newest strict instance."""
    out = {}
    step = steps.load(state["circuit"])
    pr = state["primary"]
    want = step.z_out(state["z0"], state["calls"], state["params"], pr["p"])
    out["z_mismatch"] = int(state["zi"] != want)
    out["step_rows_missing"] = step.rows_missing(*(pr["shape"][k] for k in "ABC"),
                                                 state["params"])
    for side in ("primary", "secondary"):
        s = state[side]
        A, B, C = (s["shape"][k] for k in "ABC")
        U, W = s["U"], s["W"]
        out[f"unsat_rows.{side}"] = unsat_rows(s["p"], A, B, C, W["W"], U["u"], U["X"], W["E"])
        parts = [(U["comm_W"], W["W"], W["r_W"]), (U["comm_E"], W["E"], W["r_E"])]
        if "last" in s:
            lu, lw = s["last"]["U"], s["last"]["W"]
            out["unsat_rows.last"] = unsat_rows(s["p"], A, B, C, lw["W"], 1, lu["X"])
            parts.append((lu["comm_W"], lw["W"], lw["r_W"]))
        out[f"comm_mismatch.{side}"] = _combined(
            s["curve"], s["key"], parts, seed, 17 if side == "primary" else 29, workers)
    return out


def commit_checks(curve_name: str, key: dict, pool: List[Sequence[int]],
                  done: List[tuple], seed: int, workers: int = None) -> Dict[str, int]:
    """Every commitment of the window at once: done holds (pool index,
    point) for each commit; the points' combination with coefficients from
    the seed must equal the commitment of the same combination of the
    pool's vectors (blinds 0)."""
    curve = CURVES[curve_name]
    r = curve.r
    coeff = [0] * len(pool)
    lhs = []
    for k, (j, point) in enumerate(done):
        rho = _rho(seed, 100 + k, r)
        coeff[j] = (coeff[j] + rho) % r
        lhs.append((rho, point))
    n = len(pool[0])
    vec = [0] * n
    for j, c in enumerate(coeff):
        if c:
            vj = pool[j]
            vec = [(a + c * b) % r for a, b in zip(vec, vj)]
    return {"commit_mismatch": int(combine(curve, lhs) != commit_ref(curve_name, key, vec, 0, workers)),
            "commits_missing": int(not done)}
