"""The port's bucket stage after K4, on CPU: the plain K5 (msm2's weighted
bucket reduction, a pairwise tree of bit-sums) and the plain K2s (msm3's
suffix pass of the column-end carries into bucket rows) against the JAX
package's functions and host affine sums.

The addition orders differ from the JAX package's Hillis-Steele passes, so
results are compared as affine points (exact), per bucket. Inputs are
multiples of the Pallas generator with random Z, made from numpy seeds. The
JAX functions are jitted once at 256 rows (shorter inputs padded with zero
rows or digit -1, which change no total; the two compiles, ~25 s each on a
CPU, run in parallel threads). At 512 and 4,096 rows, where each would need
another compile (and a 4,096-row call takes ~10 s), the host sums are the
oracle; tests/test_torch_msm.py holds K5 against _weighted_reduce_xla at
512 rows."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_tpu.curves.msm_host import msm as host_msm
from nova_tpu.curves.spec import AffinePoint, pallas as JCURVE
from nova_tpu.fields.jfield import JField
from nova_tpu.ops import msm3 as jmsm3

from nova_tpu_torch.curves.spec import pallas as TCURVE
from nova_tpu_torch.fields.tfield import TField
from nova_tpu_torch.ops import msm2, msm3

# One intra-op thread per test process: the plain versions issue many small
# ops, and thread-pool contention slows those by orders of magnitude.
torch.set_num_threads(1)

KEYS = ("x", "y", "zz", "zzz")
P = JCURVE.base.p
R_MONT = (1 << 256) % P
JAX_ROWS = 256
CASES = ("random", "empty", "one", "equal", "negate", "holes")
SUFFIX_KINDS = ("singletons", "spanning", "whole", "padded")


# discrete logs of the points the tests use: (x, y) -> k with the point k G
_DLOG = {}


@pytest.fixture(scope="module")
def mults():
    """[k G for k = 1 .. 4096] as affine points (their logs and those of
    their negations kept in _DLOG)."""
    g = AffinePoint.generator(JCURVE)
    out, acc = [], g
    for k in range(1, 4097):
        out.append(acc)
        _DLOG[(acc.x, acc.y)] = k
        _DLOG[(acc.x, (-acc.y) % P)] = -k
        acc = acc.add(g)
    return out


def _limbs(vals):
    """Host ints -> (n, 16) uint32 16-bit limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).astype(np.uint32)


def _xyzz_rows(points, rng):
    """Affine points (None = identity) -> dict of (n, 16) uint32 Montgomery
    XYZZ rows with a random Z per row (identities all zero)."""
    cols = {k: [] for k in KEYS}
    for pt in points:
        if pt is None:
            for k in KEYS:
                cols[k].append(0)
            continue
        z = int(rng.integers(1, 1 << 62))
        zz = z * z % P
        zzz = zz * z % P
        for k, v in zip(KEYS, (pt.x * zz, pt.y * zzz, zz, zzz)):
            cols[k].append(v % P * R_MONT % P)
    return {k: _limbs(v) for k, v in cols.items()}


def _row_int(row) -> int:
    return int.from_bytes(np.asarray(row).reshape(-1).astype("<u2").tobytes(), "little")


def _affine(rows, i=0):
    """Row i of Montgomery XYZZ rows -> affine (x, y), None for identity
    (X/ZZ and Y/ZZZ: the Montgomery factors cancel)."""
    v = {k: _row_int(np.asarray(rows[k])[i]) for k in KEYS}
    if v["zz"] == 0:
        return None
    return (v["x"] * pow(v["zz"], P - 2, P) % P, v["y"] * pow(v["zzz"], P - 2, P) % P)


def _xy(pt):
    return None if pt is None or pt.is_identity() else (pt.x, pt.y)


def _host_sum(points, weights=None) -> AffinePoint:
    """sum_i w_i P_i on the host, as (sum_i w_i log P_i) G."""
    k = sum((1 if weights is None else weights[i]) * _DLOG[(pt.x, pt.y)]
            for i, pt in enumerate(points) if pt is not None)
    return AffinePoint.generator(JCURVE).mul(k % JCURVE.scalar.p)


def _table_points(case, nb, mults, rng):
    """The affine points of a bucket table of `case` (None = empty)."""
    pick = lambda: mults[int(rng.integers(0, len(mults)))]  # noqa: E731
    if case == "empty":
        return [None] * nb
    if case == "one":
        pts = [None] * nb
        pts[int(rng.integers(0, nb))] = pick()
        return pts
    if case == "equal":  # equal partial sums: the doubling path
        return [pick()] * nb
    if case == "negate":  # P, -P pairs: sums that become the identity
        out = []
        for _ in range(nb // 2):
            q = pick()
            out += [q, q.neg()]
        return out
    pts = [pick() if rng.random() < 0.5 else pick().neg() for _ in range(nb)]
    if case == "holes":
        pts[::7] = [None] * len(pts[::7])
    return pts


def _torch_rows(rows):
    return {k: torch.from_numpy(v.astype(np.int32)) for k, v in rows.items()}


def _bucket_case(case, nb, mults):
    rng = np.random.default_rng([nb, CASES.index(case)])
    pts = _table_points(case, nb, mults, rng)
    return pts, _xyzz_rows(pts, rng)


@pytest.fixture(scope="module")
def jax_fns():
    """msm3._weighted_reduce_xla and msm3._suffix_segmented jitted at
    JAX_ROWS rows, compiled in two threads at once."""
    jf = JField(JCURVE.base)
    rows = {k: jnp.zeros((JAX_ROWS, 16), jnp.uint32) for k in KEYS}
    digs = jnp.zeros((JAX_ROWS,), jnp.int32)
    wr = jax.jit(lambda t: jmsm3._weighted_reduce_xla(jf, t))
    sf = jax.jit(lambda d, t: jmsm3._suffix_segmented(jf, d, t))
    with ThreadPoolExecutor(2) as ex:
        a = ex.submit(lambda: wr.lower(rows).compile())
        b = ex.submit(lambda: sf.lower(digs, rows).compile())
        return a.result(), b.result()


@pytest.mark.parametrize("nb", [2, JAX_ROWS])
@pytest.mark.parametrize("case", CASES)
def test_bucket_reduce_plain_matches_weighted_reduce_xla(case, nb, mults, jax_fns):
    """Plain K5's total equals the JAX package's _weighted_reduce_xla (and
    the host sum of (i+1) T_i), as affine points."""
    pts, rows = _bucket_case(case, nb, mults)
    tf = TField(TCURVE.base)
    got = _affine(msm2._bucket_reduce(tf, _torch_rows(rows)))
    pad = np.zeros((JAX_ROWS - nb, 16), np.uint32)
    want = jax_fns[0]({k: jnp.asarray(np.concatenate([v, pad])) for k, v in rows.items()})
    assert got == _affine({k: np.asarray(v).T for k, v in want.items()})
    assert got == _xy(_host_sum(pts, range(1, nb + 1)))


@pytest.mark.parametrize("case,nb", [(c, 512) for c in CASES]
                         + [(c, 4096) for c in ("random", "negate", "holes")])
def test_bucket_reduce_plain_matches_host(case, nb, mults):
    """Plain K5's total equals sum_i (i+1) T_i formed on the host at the
    sizes where the JAX oracle is too slow."""
    pts, rows = _bucket_case(case, nb, mults)
    tf = TField(TCURVE.base)
    got = _affine(msm2.bucket_reduce_plain(tf, _torch_rows(rows)))
    assert got == _xy(_host_sum(pts, range(1, nb + 1)))
    if case == "empty":
        assert got is None


@pytest.mark.parametrize("pairs", [4, 32])
def test_bucket_block_partials_match_host(pairs, mults):
    """What a K5 block of `pairs` threads writes (the tree after
    c = log2(2 * pairs) levels): per block of 2 * pairs buckets, the sum R
    and the bit-sums V_k (the buckets whose index has bit k), equal to host
    affine sums (msm_host with 0/1 scalars)."""
    nb, ch = 256, 2 * pairs
    c = ch.bit_length() - 1
    pts, rows = _bucket_case("holes", nb, mults)
    tf = TField(TCURVE.base)
    X = tuple(torch.from_numpy(rows[k].astype(np.int64))[None] for k in KEYS)
    arr = msm2._bit_sum_tree(tf.ops("cpu"), X, c)
    assert arr[0].shape == (1 + c, nb // ch, 16)
    ident = AffinePoint.identity(JCURVE)
    for b in range(nb // ch):
        block = [pts[i] or ident for i in range(b * ch, (b + 1) * ch)]
        for a in range(1 + c):
            scal = [1 if a == 0 or (i >> (a - 1)) & 1 else 0 for i in range(ch)]
            got = _affine({k: arr[j][a] for j, k in enumerate(KEYS)}, b)
            assert got == _xy(host_msm(scal, block)), (b, a)


def _suffix_case(kind, m, mults):
    """Sorted digit columns (0 inert, -1 padding at the end) and their
    XYZZ carries (every 11th an identity), nb = 2 m buckets."""
    rng = np.random.default_rng([m, SUFFIX_KINDS.index(kind)])
    nb = 2 * m
    if kind == "singletons":  # runs of length 1
        d = np.sort(rng.choice(np.arange(1, nb + 1), m, replace=False))
    elif kind == "spanning":  # a run across many slices among short runs
        d = np.sort(rng.integers(1, nb + 1, m))
        a = m // 5
        d[a : a + max(3, m // 3)] = d[a]
        d = np.sort(d)
    elif kind == "whole":  # one run over the whole column
        d = np.full(m, int(rng.integers(1, nb + 1)))
    else:  # digit-0 runs first, then sorted digits, then -1 padding
        d = np.sort(rng.integers(1, m // 4, m))
        d[: m // 8] = 0
        d[m - m // 8 :] = -1
    pts = [None if i % 11 == 5 else mults[int(rng.integers(0, len(mults)))]
           for i in range(m)]
    return d.astype(np.int32), pts, _xyzz_rows(pts, rng), nb


def _ints(rows, i):
    return {k: _row_int(np.asarray(rows[k])[i]) for k in KEYS}


def _same_point(a: dict, b: dict) -> bool:
    """Two Montgomery XYZZ points (dicts of ints) are the same affine point:
    both identities, or X1 ZZ2 = X2 ZZ1 and Y1 ZZZ2 = Y2 ZZZ1 (no inverse)."""
    if a["zz"] == 0 or b["zz"] == 0:
        return a["zz"] == b["zz"] == 0
    return (a["x"] * b["zz"] - b["x"] * a["zz"]) % P == 0 and (
        a["y"] * b["zzz"] - b["y"] * a["zzz"]) % P == 0


def _as_xyzz(xy):
    """Affine (x, y) or None -> a Montgomery XYZZ point of ints (Z = 1)."""
    if xy is None:
        return {"x": 0, "y": 0, "zz": 0, "zzz": 0}
    return {"x": xy[0] * R_MONT % P, "y": xy[1] * R_MONT % P, "zz": R_MONT, "zzz": R_MONT}


def _check_suffix_table(table, d, nb, want):
    """Rows of the digits present hold want[d] (a Montgomery XYZZ point of
    ints); every other row is zero."""
    live = table["zz"].numpy().any(axis=1) | table["x"].numpy().any(axis=1)
    for b in range(1, nb + 1):
        if b in want:
            assert _same_point(_ints(table, b - 1), want[b]), b
        else:
            assert not live[b - 1], b


@pytest.mark.parametrize("kind", SUFFIX_KINDS)
def test_suffix_to_buckets_plain_matches_suffix_segmented(kind, mults, jax_fns):
    """Plain K2s over 256 carries (one carry per slice): each run's total at
    row d - 1 equals the JAX package's _suffix_segmented at the run's head
    (its first position, as the JAX package's _bucket_totals finds it), as
    affine points; digits 0 and -1 write nothing."""
    d, _, rows, nb = _suffix_case(kind, JAX_ROWS, mults)
    tf = TField(TCURVE.base)
    table = msm3.suffix_to_buckets(tf, torch.from_numpy(d), _torch_rows(rows), nb)
    sums = jax_fns[1](jnp.asarray(d), {k: jnp.asarray(v) for k, v in rows.items()})
    sums = {k: np.asarray(v) for k, v in sums.items()}
    want = {int(b): _ints(sums, int(np.flatnonzero(d == b)[0]))
            for b in np.unique(d) if 1 <= b <= nb}
    _check_suffix_table(table, d, nb, want)


@pytest.mark.parametrize("kind", SUFFIX_KINDS)
def test_suffix_to_buckets_plain_4096_matches_host(kind, mults):
    """Plain K2s over 4,096 carries (16 per slice, so runs span slices and
    slices hold several runs): each run's total equals its host affine
    sum."""
    d, pts, rows, nb = _suffix_case(kind, 4096, mults)
    tf = TField(TCURVE.base)
    table = msm3.suffix_to_buckets_plain(tf, torch.from_numpy(d), _torch_rows(rows), nb)
    want = {int(b): _as_xyzz(_xy(_host_sum([pts[i] for i in np.flatnonzero(d == b)])))
            for b in np.unique(d) if 1 <= b <= nb}
    _check_suffix_table(table, d, nb, want)
