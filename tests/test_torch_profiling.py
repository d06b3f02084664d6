"""The port's tracer (``nova_tpu_torch.profiling``): spans that nest and
keep their start, end and parent while a recorder is active; counters;
nothing recorded, no environment read and no device synchronised while
tracing is off; and the spans and counters placed in the fold step and
the MSM (the element conversions of ``TField.pack``/``unpack``,
``FVec.to_ints`` and ``msm2._scalar_limbs``, the device SpMV, the MSM's
read and rerun, NIFS's four parts). CPU only, plain versions, tiny sizes."""

import os

import numpy as np
import pytest
import torch

from nova_tpu_torch import native, profiling
from nova_tpu_torch.fields.spec import pallas_scalar
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm2, msm3
from nova_tpu_torch.ops.fvec import FVec
from nova_tpu_torch.ops.spmv import multiply_vec_device

torch.set_num_threads(1)
P = pallas_scalar.p


@pytest.fixture
def tracing():
    """Tracing on with empty totals and counters; the state before is put
    back after."""
    was = profiling.enabled()
    profiling.take_spans()
    profiling.global_reset()
    profiling.enable()
    yield profiling
    profiling.take_spans()
    profiling.global_reset()
    profiling.enable(was)


def _nest(raise_in_c: bool):
    with profiling.phase("a"):
        with profiling.phase("b"):
            try:
                with profiling.phase("c"):
                    if raise_in_c:
                        raise KeyError("c")
            except KeyError:
                pass
        with profiling.phase("d"):
            pass
    with profiling.phase("e"):
        pass


@pytest.mark.parametrize("raise_in_c", [False, True])
def test_spans_nest_with_parents_and_times_inside_them(tracing, raise_in_c):
    tracing.start_spans()
    _nest(raise_in_c)
    spans = tracing.take_spans()
    assert [s[2] for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s[3] for s in spans] == [None, 0, 1, 0, None]
    starts = [s[0] for s in spans]
    assert starts == sorted(starts)
    for a, b, _, parent in spans:
        assert a <= b
        if parent is not None:
            pa, pb = spans[parent][:2]
            assert pa <= a and b <= pb
    assert spans[0][1] <= spans[4][0]
    assert dict(tracing._GLOBAL.counts) == {n: 1 for n in "abcde"}
    assert set(tracing._GLOBAL.totals) == set("abcde")


def test_take_spans_hands_over_and_empties(tracing):
    tracing.start_spans()
    with tracing.phase("x"):
        pass
    assert [s[2] for s in tracing.take_spans()] == ["x"]
    assert tracing.take_spans() == []
    with tracing.phase("y"):  # not kept, but still totalled
        pass
    assert tracing.take_spans() == []
    assert set(tracing._GLOBAL.totals) == {"x", "y"}


def test_a_span_open_at_take_ends_there(tracing):
    tracing.start_spans()
    with tracing.phase("outer"):
        with tracing.phase("inner"):
            pass
        spans = tracing.take_spans()
    assert [s[2] for s in spans] == ["outer", "inner"]
    assert spans[1][1] <= spans[0][1]
    assert tracing.take_spans() == [] and tracing._GLOBAL.counts["outer"] == 1


def test_counters(tracing):
    tracing.count("a")
    tracing.count("a", 5)
    tracing.count("b", 0)
    assert tracing.counters() == {"a": 6, "b": 0}
    assert "a" in tracing.global_report() and "6" in tracing.global_report()
    tracing.global_reset()
    assert tracing.counters() == {} and not tracing._GLOBAL.totals


def test_off_records_nothing(tracing):
    tracing.enable(False)
    assert tracing.phase("a") is tracing.phase("b")  # one shared object, nothing built
    _nest(False)
    tracing.count("c", 3)
    TField(pallas_scalar).pack([1, 2, 3])
    assert tracing.take_spans() == []
    assert not tracing._GLOBAL.totals and not tracing._GLOBAL.counts
    assert tracing.counters() == {}


class _NoEnv(dict):
    def _refuse(self, *a, **k):
        raise AssertionError("the environment was read")

    get = __getitem__ = __contains__ = _refuse


@pytest.mark.parametrize("on", [False, True])
def test_phase_and_count_read_no_environment_and_never_sync(tracing, monkeypatch, on):
    tracing.enable(on)

    def refuse(*a, **k):
        raise AssertionError("the device was synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(os, "environ", _NoEnv())
    with tracing.phase("p"):
        tracing.count("n", 2)
    monkeypatch.undo()
    assert tracing.counters() == ({"n": 2} if on else {})


@pytest.mark.parametrize("n", [0, 1, 7])
def test_pack_unpack_and_scalar_limbs_count_elements(tracing, n):
    tf = TField(pallas_scalar)
    vals = [(3**k * 12345) % P for k in range(n)]
    arr = tf.pack(vals)
    assert tracing.counters() == {"conv.to_device": n}
    assert tf.unpack(torch.from_numpy(arr)) == vals
    assert tf.unpack(arr) == vals
    assert tracing.counters() == {"conv.to_device": n, "conv.to_host": 2 * n}
    msm2._scalar_limbs(vals, 512)
    assert tracing.counters()["conv.to_device"] == 2 * n


@pytest.mark.parametrize("route", ["native", "plain"])
def test_fvec_crossings_counted_once(tracing, monkeypatch, route):
    n = 5
    v = FVec.from_ints(pallas_scalar, list(range(1, n + 1)), device="cpu")
    assert tracing.counters() == {"conv.to_device": n}
    w = v.scale(3)  # a device result: no host ints yet
    if route == "native":
        monkeypatch.setattr(native, "available", lambda: True)
        monkeypatch.setattr(native, "vec_from_mont_l", lambda p, m: m)
        monkeypatch.setattr(native, "limbs_to_ints", lambda l: [0] * l.shape[0])
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    w.to_ints()
    w.to_ints()  # cached: no second crossing
    assert tracing.counters() == {"conv.to_device": n, "conv.to_host": n}


def _shape(num_cons: int, num_vars: int, num_io: int = 2, seed: int = 0):
    from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

    rng = np.random.default_rng(seed)
    cols = num_vars + 1 + num_io
    mats = []
    for _ in range(3):
        trip = {(r, int(rng.integers(cols))): int(rng.integers(1, 1 << 30))
                for r in range(num_cons) for _ in range(2)}
        mats.append(SparseMatrix.new(pallas_scalar, [(r, c, v) for (r, c), v in trip.items()],
                                     num_cons, cols))
    return R1CSShape.new(pallas_scalar, num_cons, num_vars, num_io, *mats)


@pytest.mark.parametrize("num_cons,num_vars", [(4, 3), (16, 13)])
def test_device_spmv_counts_its_crossings_and_spans_them(tracing, num_cons, num_vars):
    S = _shape(num_cons, num_vars)
    z = [(7 * k + 1) % P for k in range(num_vars + 1 + S.num_io)]
    want = multiply_vec_device(S, z, "cpu")  # marshals the matrices, once
    tracing.global_reset()
    tracing.start_spans()
    assert multiply_vec_device(S, z, "cpu") == want
    spans = tracing.take_spans()
    c = tracing.counters()
    assert c["conv.to_device"] + c["conv.to_host"] == len(z) + 3 * num_cons
    assert c == {"conv.to_device": len(z), "conv.to_host": 3 * num_cons}
    assert [s[2] for s in spans] == ["spmv"]


@pytest.mark.parametrize("degenerate", [False, True])
def test_msm_read_counts_calls_and_reruns(tracing, monkeypatch, degenerate):
    out = {"x": torch.zeros((1, 16), dtype=torch.int32)}
    rerun = {"x": torch.ones((1, 16), dtype=torch.int32)}
    monkeypatch.setattr(msm3, "_msm3_finish", lambda *a: (rerun, None))
    tracing.start_spans()
    got = msm3._msm3_collect((None, None, None, 16, out, torch.tensor(degenerate)))
    spans = tracing.take_spans()
    assert torch.equal(got["x"], (rerun if degenerate else out)["x"])
    assert tracing.counters() == ({"msm.calls": 1, "msm.reruns": 1} if degenerate
                                  else {"msm.calls": 1})
    names = [(s[2], s[3]) for s in spans]
    assert names == ([("msm.read", None), ("msm.rerun", 0)] if degenerate
                     else [("msm.read", None)])


def _cubic():
    """x^3 + x + 5 = y on z = (vars, u, x, y) (src/r1cs/mod.rs:1294-1358)."""
    from nova_tpu_torch.r1cs import R1CSShape, SparseMatrix

    nv, cols = 4, 7
    A = [(0, 5, 1), (1, 0, 1), (2, 1, 1), (2, 5, 1), (3, 2, 1), (3, 4, 5)]
    B = [(0, 5, 1), (1, 5, 1), (2, 4, 1), (3, 4, 1)]
    C = [(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, 6, 1)]
    return R1CSShape.new(pallas_scalar, 4, nv, 2,
                         *(SparseMatrix.new(pallas_scalar, M, 4, cols) for M in (A, B, C)))


def test_nifs_marks_its_four_parts(tracing, monkeypatch):
    from nova_tpu_torch.curves.spec import AffinePoint, pallas
    from nova_tpu_torch.nova.nifs import NIFS
    from nova_tpu_torch.provider.engines import PallasEngine
    from nova_tpu_torch.provider.pedersen import CommitmentKey
    from nova_tpu_torch.r1cs import (R1CSInstance, R1CSWitness, RelaxedR1CSInstance,
                                     RelaxedR1CSWitness)

    monkeypatch.setattr(native, "available", lambda: False)  # the host list route
    S = _cubic()
    g = AffinePoint.generator(pallas)
    ck = CommitmentKey(pallas, [g.mul(k + 2) for k in range(4)], g.mul(11), "cpu")
    x = 3
    W = R1CSWitness.new(S, [x * x, x ** 3, x ** 3 + x, 0], r_W=5)
    U = R1CSInstance.new(S, W.commit(ck), [x, x ** 3 + x + 5])
    tracing.global_reset()
    tracing.start_spans()
    with tracing.phase("nifs_primary"):
        NIFS.prove(ck, PallasEngine, 0x1234, S, RelaxedR1CSInstance.default(pallas, S),
                   RelaxedR1CSWitness.default(S), U, W, r_T=9)
    spans = tracing.take_spans()
    assert [(s[2], s[3]) for s in spans] == [
        ("nifs_primary", None), ("nifs.ro", 0), ("nifs.cross_term", 0),
        ("nifs.commit_T", 0), ("nifs.ro", 0), ("nifs.fold", 0)]
