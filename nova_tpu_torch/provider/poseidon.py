"""Poseidon hash: constants generation, permutation, sponge, and the Nova RO.

This is an exact re-derivation of the vendored-neptune Poseidon the reference
uses (src/frontend/gadgets/poseidon/*, credited to argumentcomputer/neptune at
src/frontend/gadgets/poseidon/mod.rs:1), so that Nova's Poseidon random
oracle (src/provider/poseidon.rs) produces bit-identical outputs:

- round numbers: port of round_numbers.rs:48-91 with faithful f32 semantics
  (numpy.float32 mirrors Rust f32 IEEE-754 ops).
- round constants: Grain LFSR in self-shrinking mode (round_constants.rs).
- MDS: Cauchy matrix m[i][j] = 1/(x_i + y_j), x_i = i, y_j = t + j
  (mds.rs:104-136), plus the M = M'·M'' sparse factorization used by the
  optimized-static permutation (mds.rs:76-102).
- permutation: the OptimizedStatic evaluation order of poseidon_inner.rs
  (compressed round constants, pre-sparse matrix, sparse matrices).
- sponge: the 'Secure Sponge API for Field Elements' in Simplex mode with
  the 128-bit IOPattern domain tag (sponge/api.rs:26-102, vanilla.rs).
- RO: PoseidonRO semantics (src/provider/poseidon.rs:37-123): absorb state,
  single squeeze with bit truncation and optional forced MSB; Wide (arity
  24) and Narrow (arity 5) modes.

Constants are derived once per (field, arity) and cached on disk.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field

import numpy as np

from nova_tpu_torch.fields.spec import FieldSpec

# ---------------------------------------------------------------------------
# Round numbers (round_numbers.rs) — f32-faithful
# ---------------------------------------------------------------------------

_PRIME_BITLEN = 256
_M_SEC = 128


def _round_numbers_are_secure(t: int, rf: int, rp: int) -> bool:
    f32 = np.float32
    rp_f, t_f, n_f, m_f = f32(rp), f32(t), f32(_PRIME_BITLEN), f32(_M_SEC)
    rf_stat = f32(6.0) if m_f <= (n_f - f32(3.0)) * (t_f + f32(1.0)) else f32(10.0)
    rf_interp = f32(0.43) * m_f + f32(np.log2(t_f)) - rp_f
    rf_grob_1 = f32(0.21) * n_f - rp_f
    rf_grob_2 = (f32(0.14) * n_f - f32(1.0) - rp_f) / (t_f - f32(1.0))
    # Rust: .ceil() as usize on f32 (negative values saturate to 0 via `as usize`)
    def ceil_usize(x):
        c = float(np.ceil(x))
        return int(c) if c > 0 else 0
    rf_max = max(ceil_usize(v) for v in (rf_stat, rf_interp, rf_grob_1, rf_grob_2))
    return rf >= rf_max


def calc_round_numbers(t: int, security_margin: bool = True):
    """Port of round_numbers.rs:48-71."""
    rf, rp, n_sboxes_min = 0, 0, 1 << 62
    for rf_test0 in range(2, 1001, 2):
        for rp_test0 in range(4, 200):
            if _round_numbers_are_secure(t, rf_test0, rp_test0):
                rf_test, rp_test = rf_test0, rp_test0
                if security_margin:
                    rf_test = rf_test0 + 2
                    rp_test = int(np.ceil(np.float32(1.075) * np.float32(rp_test0)))
                n_sboxes = t * rf_test + rp_test
                if n_sboxes < n_sboxes_min or (n_sboxes == n_sboxes_min and rf_test < rf):
                    rf, rp, n_sboxes_min = rf_test, rp_test, n_sboxes
    return rf, rp


def round_numbers_base(arity: int):
    return calc_round_numbers(arity + 1, True)


# ---------------------------------------------------------------------------
# Grain LFSR round-constant generation (round_constants.rs)
# ---------------------------------------------------------------------------

class _Grain:
    def __init__(self, init_sequence, field_size: int):
        assert len(init_sequence) == 80
        self.state = list(init_sequence)
        self.field_size = field_size
        for _ in range(160):
            self._generate_new_bit()

    def _generate_new_bit(self) -> bool:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def _next(self) -> bool:
        # self-shrinking: Iterator::next in round_constants.rs:155-167
        new_bit = self._generate_new_bit()
        while not new_bit:
            self._generate_new_bit()
            new_bit = self._generate_new_bit()
        return self._generate_new_bit()

    def _next_byte(self, bit_count: int) -> int:
        acc = 0
        for _ in range(bit_count):
            acc = (acc << 1) | (1 if self._next() else 0)
        return acc

    def get_next_bytes(self, n_bytes: int) -> bytes:
        remainder_bits = self.field_size % 8
        out = bytearray()
        out.append(self._next_byte(remainder_bits if remainder_bits > 0 else 8))
        for _ in range(n_bytes - 1):
            out.append(self._next_byte(8))
        return bytes(out)


def _append_bits(vec, n, val):
    for i in range(n - 1, -1, -1):
        vec.append(bool((val >> i) & 1))


def generate_constants(field: FieldSpec, t: int, r_f: int, r_p: int):
    """Port of round_constants.rs:29-82 (field=1, sbox=1)."""
    field_size = field.num_bits
    num_constants = (r_f + r_p) * t
    seq = []
    _append_bits(seq, 2, 1)  # field = 1 (prime)
    _append_bits(seq, 4, 1)  # sbox = 1 (x^5)
    _append_bits(seq, 12, field_size)
    _append_bits(seq, 12, t)
    _append_bits(seq, 10, r_f)
    _append_bits(seq, 10, r_p)
    _append_bits(seq, 30, (1 << 30) - 1)
    grain = _Grain(seq, field_size)
    out = []
    for _ in range(num_constants):
        while True:
            # 32 big-endian bytes, then reversed to little-endian repr
            repr_be = grain.get_next_bytes(32)
            v = field.from_repr(repr_be[::-1])
            if v is not None:
                out.append(v)
                break
    return out


# ---------------------------------------------------------------------------
# Matrix utilities over F_p (matrix.rs conventions: m[row][col])
# ---------------------------------------------------------------------------

def _mat_identity(f: FieldSpec, n: int):
    return [[1 if i == j else 0 for j in range(n)] for i in range(n)]


def mat_invert(f: FieldSpec, m):
    """Gauss-Jordan inverse; None if singular."""
    n = len(m)
    a = [row[:] + ident_row[:] for row, ident_row in zip(m, _mat_identity(f, n))]
    p = f.p
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r][col] != 0:
                piv = r
                break
        if piv is None:
            return None
        a[col], a[piv] = a[piv], a[col]
        inv_p = f.inv(a[col][col])
        a[col] = [x * inv_p % p for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0:
                factor = a[r][col]
                a[r] = [(x - factor * y) % p for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def mat_mul(f: FieldSpec, a, b):
    p = f.p
    bt = list(zip(*b))
    return [[sum(x * y for x, y in zip(row, col)) % p for col in bt] for row in a]


def left_apply_matrix(f: FieldSpec, m, v):
    """M·v with v a column vector (matrix.rs:98-116)."""
    p = f.p
    return [sum(mv * vv for mv, vv in zip(row, v)) % p for row in m]


def _minor(m, i, j):
    return [[v for cidx, v in enumerate(row) if cidx != j] for ridx, row in enumerate(m) if ridx != i]


# ---------------------------------------------------------------------------
# MDS generation + sparse factorization (mds.rs)
# ---------------------------------------------------------------------------

def generate_mds(f: FieldSpec, t: int):
    return [[f.inv((i + t + j) % f.p) for j in range(t)] for i in range(t)]


def _make_prime(m):
    out = []
    for i, row in enumerate(m):
        if i == 0:
            new = [0] * len(row)
            new[0] = 1
        else:
            new = [0] * len(row)
            new[1:] = row[1:]
        out.append(new)
    return out


def _make_double_prime(f: FieldSpec, m, m_hat_inv):
    v = m[0][1:]
    w = [row[0] for row in m[1:]]
    w_hat = left_apply_matrix(f, m_hat_inv, w)
    out = []
    for i, row in enumerate(m):
        if i == 0:
            new = [row[0]] + list(v)
        else:
            new = [0] * len(row)
            new[0] = w_hat[i - 1]
            new[i] = 1
        out.append(new)
    return out


@dataclass
class MdsMatrices:
    m: list
    m_inv: list
    m_hat: list
    m_hat_inv: list
    m_prime: list
    m_double_prime: list


def derive_mds_matrices(f: FieldSpec, m) -> MdsMatrices:
    m_inv = mat_invert(f, m)
    m_hat = _minor(m, 0, 0)
    m_hat_inv = mat_invert(f, m_hat)
    m_prime = _make_prime(m)
    m_double_prime = _make_double_prime(f, m, m_hat_inv)
    return MdsMatrices(m, m_inv, m_hat, m_hat_inv, m_prime, m_double_prime)


def factor_to_sparse_matrixes(f: FieldSpec, base_matrix, n: int):
    """Port of mds.rs:76-102. Returns (pre_sparse, [(w_hat, v_rest)])."""
    curr = [row[:] for row in base_matrix]
    acc = []
    for _ in range(n):
        derived = derive_mds_matrices(f, curr)
        acc.append(derived.m_double_prime)
        curr = mat_mul(f, base_matrix, derived.m_prime)
    acc.reverse()
    sparse = [([row[0] for row in mdp], mdp[0][1:]) for mdp in acc]
    return curr, sparse


# ---------------------------------------------------------------------------
# Compressed round constants (preprocessing.rs, fully preprocessed case)
# ---------------------------------------------------------------------------

def compress_round_constants(f: FieldSpec, width, full_rounds, partial_rounds, round_constants, m_inv):
    p = f.p

    def round_keys(r):
        return round_constants[r * width : (r + 1) * width]

    res = []
    half_full = full_rounds // 2
    res.extend(round_keys(0))

    # unpreprocessed = 0 (partial_preprocessed == partial_rounds)
    end = half_full - 1
    for i in range(end):
        res.extend(left_apply_matrix(f, m_inv, round_keys(i + 1)))

    partial_keys = []
    final_round = half_full + partial_rounds
    acc = list(round_keys(final_round))
    for i in range(partial_rounds):
        inverted = left_apply_matrix(f, m_inv, acc)
        partial_keys.append(inverted[0])
        inverted[0] = 0
        prev = round_keys(final_round - i - 1)
        acc = [(a + b) % p for a, b in zip(prev, inverted)]

    res.extend(left_apply_matrix(f, m_inv, acc))
    while partial_keys:
        res.append(partial_keys.pop())

    for i in range(1, half_full):
        start = half_full + partial_rounds
        res.extend(left_apply_matrix(f, m_inv, round_keys(i + start)))

    assert len(res) == full_rounds * width + partial_rounds
    return res


# ---------------------------------------------------------------------------
# PoseidonConstants (cached per field+arity)
# ---------------------------------------------------------------------------

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "_cache")


@dataclass
class PoseidonConstants:
    field: FieldSpec
    arity: int
    full_rounds: int
    partial_rounds: int
    round_constants: list
    compressed_round_constants: list
    m: list  # MDS matrix (symmetric)
    pre_sparse_matrix: list
    sparse_matrixes: list  # list of (w_hat, v_rest)
    domain_tag: int  # HashType::Sponge => 0
    # the native permutation's context, built once (native_ctx)
    _native_ctx: object = dc_field(default=None, repr=False, compare=False)

    @property
    def width(self):
        return self.arity + 1

    @property
    def half_full_rounds(self):
        return self.full_rounds // 2


_CONSTANTS_CACHE: dict = {}


def api_constants(field: FieldSpec, arity: int) -> PoseidonConstants:
    """Sponge::api_constants(Strength::Standard): HashType::Sponge constants."""
    key = (field.p, arity)
    if key in _CONSTANTS_CACHE:
        return _CONSTANTS_CACHE[key]

    path = os.path.join(_CACHE_DIR, f"poseidon_{field.name}_a{arity}.json")
    if os.path.exists(path):
        with open(path) as fh:
            d = json.load(fh)
        consts = PoseidonConstants(
            field=field,
            arity=arity,
            full_rounds=d["rf"],
            partial_rounds=d["rp"],
            round_constants=[int(x, 16) for x in d["rc"]],
            compressed_round_constants=[int(x, 16) for x in d["crc"]],
            m=[[int(x, 16) for x in row] for row in d["m"]],
            pre_sparse_matrix=[[int(x, 16) for x in row] for row in d["pre"]],
            sparse_matrixes=[
                ([int(x, 16) for x in w], [int(x, 16) for x in v]) for w, v in d["sparse"]
            ],
            domain_tag=0,
        )
        _CONSTANTS_CACHE[key] = consts
        return consts

    t = arity + 1
    rf, rp = round_numbers_base(arity)
    rc = generate_constants(field, t, rf, rp)
    mds = generate_mds(field, t)
    derived = derive_mds_matrices(field, mds)
    crc = compress_round_constants(field, t, rf, rp, rc, derived.m_inv)
    # poseidon_inner.rs:189-190: factor from transpose(m); m is symmetric so
    # transpose(m) == m, but we transpose anyway for fidelity.
    pre_sparse, sparse = factor_to_sparse_matrixes(field, [list(r) for r in zip(*mds)], rp)

    consts = PoseidonConstants(
        field=field,
        arity=arity,
        full_rounds=rf,
        partial_rounds=rp,
        round_constants=rc,
        compressed_round_constants=crc,
        m=mds,
        pre_sparse_matrix=pre_sparse,
        sparse_matrixes=sparse,
        domain_tag=0,
    )
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # concurrent test workers may race
    with open(tmp, "w") as fh:
        json.dump(
            {
                "rf": rf,
                "rp": rp,
                "rc": [hex(x) for x in rc],
                "crc": [hex(x) for x in crc],
                "m": [[hex(x) for x in row] for row in mds],
                "pre": [[hex(x) for x in row] for row in pre_sparse],
                "sparse": [[[hex(x) for x in w], [hex(x) for x in v]] for w, v in sparse],
            },
            fh,
        )
    os.replace(tmp, path)
    _CONSTANTS_CACHE[key] = consts
    return consts


# ---------------------------------------------------------------------------
# Permutation (poseidon_inner.rs, OptimizedStatic)
# ---------------------------------------------------------------------------

def native_ctx(consts: PoseidonConstants):
    """The native binding's permutation context for `consts`, built on
    first use and kept on the constants object; None without the binding."""
    from nova_tpu_torch import native

    if not native.available():
        return None
    if consts._native_ctx is None:
        consts._native_ctx = native.poseidon_ctx(
            consts.field.p, consts.width, consts.half_full_rounds,
            consts.partial_rounds, consts.compressed_round_constants, consts.m,
            consts.pre_sparse_matrix, consts.sparse_matrixes,
        )
    return consts._native_ctx


def permute(consts: PoseidonConstants, elements: list) -> list:
    """One Poseidon permutation over `width` field elements, matching
    hash_optimized_static (poseidon_inner.rs:316-343)."""
    f = consts.field
    p = f.p
    h = native_ctx(consts)
    if h is not None:
        from nova_tpu_torch import native

        return native.poseidon_permute(h, p, elements, width=consts.width)
    width = consts.width
    crc = consts.compressed_round_constants
    el = list(elements)
    offset = 0
    current_round = 0
    half_full = consts.half_full_rounds
    sparse_offset = half_full - 1

    def sbox(x):
        x2 = x * x % p
        x4 = x2 * x2 % p
        return x4 * x % p

    def apply_mds():
        nonlocal el, current_round
        if current_round == sparse_offset:
            # product_mds_with_matrix: result[j] = sum_i M[i][j] * el[i]
            m = consts.pre_sparse_matrix
            el = [sum(m[i][j] * el[i] for i in range(width)) % p for j in range(width)]
        elif sparse_offset < current_round < half_full + consts.partial_rounds:
            w_hat, v_rest = consts.sparse_matrixes[current_round - sparse_offset - 1]
            r0 = sum(w * e for w, e in zip(w_hat, el)) % p
            new = [r0] + [
                (el[j] + v_rest[j - 1] * el[0]) % p for j in range(1, width)
            ]
            el = new
        else:
            m = consts.m
            el = [sum(m[i][j] * el[j] for j in range(width)) % p for i in range(width)]
        current_round += 1

    # initial constant add
    for i in range(width):
        el[i] = (el[i] + crc[offset + i]) % p
    offset += width

    # first half full rounds
    for _ in range(half_full):
        el = [(sbox(x) + crc[offset + i]) % p for i, x in enumerate(el)]
        offset += width
        apply_mds()

    # partial rounds
    for _ in range(consts.partial_rounds):
        el[0] = (sbox(el[0]) + crc[offset]) % p
        offset += 1
        apply_mds()

    # last full rounds (all but final add post keys)
    for _ in range(1, half_full):
        el = [(sbox(x) + crc[offset + i]) % p for i, x in enumerate(el)]
        offset += width
        apply_mds()
    # final full round: sbox only, no constant add
    el = [sbox(x) for x in el]
    apply_mds()

    assert offset == len(crc)
    return el


# ---------------------------------------------------------------------------
# Sponge API (sponge/api.rs + vanilla.rs, Simplex mode)
# ---------------------------------------------------------------------------

_HASHER_BASE = (1 << 128) - 159
_U128_MASK = (1 << 128) - 1


def io_pattern_value(pattern, domain_separator: int = 0) -> int:
    """128-bit IOPattern tag (api.rs:26-102). `pattern` is a list of
    ('absorb'|'squeeze', count)."""
    x = _HASHER_BASE
    x_i = 1
    state = 0
    # coalesce runs
    coalesced = []
    for kind, count in pattern:
        if coalesced and coalesced[-1][0] == kind:
            coalesced[-1] = (kind, coalesced[-1][1] + count)
        else:
            coalesced.append((kind, count))

    def update(a):
        nonlocal x_i, state
        x_i = (x_i * x) & _U128_MASK
        state = (state + x_i * a) & _U128_MASK

    for kind, count in coalesced:
        if count == 0:
            continue
        v = count + (1 << 31) if kind == "absorb" else count
        update(v)
    update(domain_separator)
    return state


class PoseidonSponge:
    """Simplex-mode sponge over one PoseidonConstants instance."""

    def __init__(self, consts: PoseidonConstants):
        self.consts = consts
        self.rate = consts.arity
        self.state = [consts.domain_tag] + [0] * consts.arity
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def start(self, pattern, domain_separator: int = 0):
        tag = io_pattern_value(pattern, domain_separator)
        # initialize_capacity: tag's 16 LE bytes into a zeroed 32-byte repr
        self.state = [tag % self.consts.field.p] + [0] * self.rate
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def _permute(self):
        self.state = permute(self.consts, self.state)
        self.absorb_pos = 0
        self.squeeze_pos = 0

    def absorb(self, elements):
        p = self.consts.field.p
        for x in elements:
            if self.absorb_pos == self.rate:
                self._permute()
            self.state[1 + self.absorb_pos] = (self.state[1 + self.absorb_pos] + x) % p
            self.absorb_pos += 1
        self.squeeze_pos = self.rate

    def squeeze(self, length: int):
        out = []
        for _ in range(length):
            if self.squeeze_pos == self.rate:
                self._permute()
                self.squeeze_pos = 0
                self.absorb_pos = 0
            out.append(self.state[1 + self.squeeze_pos])
            self.squeeze_pos += 1
        return out


def sponge_hash(consts: PoseidonConstants, inputs) -> int:
    """absorb-n/squeeze-1 (poseidon_squeeze_native, src/provider/poseidon.rs:47-62)."""
    sponge = PoseidonSponge(consts)
    sponge.start([("absorb", len(inputs)), ("squeeze", 1)])
    sponge.absorb(list(inputs))
    return sponge.squeeze(1)[0]


# ---------------------------------------------------------------------------
# Nova's random oracle (src/provider/poseidon.rs:37-123)
# ---------------------------------------------------------------------------

WIDE_ARITY = 24
NARROW_ARITY = 5


class PoseidonROConstants:
    """Wide+Narrow constants bundle (PoseidonConstantsCircuit)."""

    _cache: dict = {}

    def __new__(cls, field: FieldSpec):
        if field.p in cls._cache:
            return cls._cache[field.p]
        self = super().__new__(cls)
        self.field = field
        self.wide = api_constants(field, WIDE_ARITY)
        self.narrow = api_constants(field, NARROW_ARITY)
        cls._cache[field.p] = self
        return self


class PoseidonRO:
    """The Nova random oracle over a base field. absorb() accumulates field
    elements; squeeze() hashes them all (one sponge), truncates to num_bits
    (LE bit order), optionally forces the MSB, and resets state to [hash]."""

    def __init__(self, constants: PoseidonROConstants, mode: str = "wide"):
        self.constants = constants
        self.mode = mode
        self.state = []

    def absorb(self, e: int):
        self.state.append(e)

    def squeeze(self, num_bits: int, start_with_one: bool = False) -> int:
        consts = self.constants.wide if self.mode == "wide" else self.constants.narrow
        h = sponge_hash(consts, self.state)
        self.state = [h]
        res = h & ((1 << num_bits) - 1)
        if start_with_one:
            res |= 1 << (num_bits - 1)
        return res

    def squeeze_scalar(self) -> int:
        """Full-field squeeze (ROCircuitTrait::squeeze_scalar analog)."""
        consts = self.constants.wide if self.mode == "wide" else self.constants.narrow
        h = sponge_hash(consts, self.state)
        self.state = [h]
        return h
