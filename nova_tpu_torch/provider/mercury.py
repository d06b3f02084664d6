"""Mercury: constant-proof-size multilinear PCS (port of
``nova_tpu/provider/mercury.py``; reference: src/provider/mercury.rs,
eprint 2025/385).

Opens a multilinear polynomial with 2n + O(sqrt n) scalar muls and an O(1)
proof (8 commitments + 6 scalars), verified with 2 pairings. Shares the
powers-of-tau key with HyperKZG. Needs a radix-2 NTT over the scalar field
(BN254 Fr has 2-adicity 28) for the s-polynomial product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from nova_tpu_torch import native
from nova_tpu_torch.curves.msm_host import msm as host_msm
from nova_tpu_torch.curves.pairing import G2Point, multi_pairing_is_one
from nova_tpu_torch.errors import ProofVerifyError
from nova_tpu_torch.provider.hyperkzg import EvaluationEngine as KZG, HyperKZGVerifierKey
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine as CE, CommitmentKey
from nova_tpu_torch.spartan.polys import EqPolynomial

# transcript labels (mercury.rs:45-93)
L_F, L_U, L_E = b"f", b"u", b"e"
L_H, L_Q, L_G, L_S, L_D, L_QUOT_F = b"h", b"q", b"g", b"s", b"d", b"t"
L_GZ, L_GZI, L_HZ, L_HZI, L_SZ, L_SZI = b"gz", b"gzi", b"hz", b"hzi", b"sz", b"szi"
L_W, L_WP = b"w", b"wp"
L_ALPHA, L_GAMMA, L_ZETA, L_BETA, L_Z, L_PAIRING_D = b"a", b"gm", b"zt", b"b", b"z", b"pd"


# ---------------------------------------------------------------------------
# field/NTT helpers
# ---------------------------------------------------------------------------

_ROOT_CACHE: dict = {}


def _two_adic_root(p: int) -> Tuple[int, int]:
    """(root of maximal 2-power order, s) with root^(2^s) = 1."""
    if p in _ROOT_CACHE:
        return _ROOT_CACHE[p]
    t = p - 1
    s = 0
    while t % 2 == 0:
        t //= 2
        s += 1
    c = 2
    while pow(c, (p - 1) // 2, p) != p - 1:
        c += 1
    root = pow(c, t, p)
    _ROOT_CACHE[p] = (root, s)
    return root, s


def omega(p: int, log_n: int) -> int:
    root, s = _two_adic_root(p)
    assert log_n <= s
    return pow(root, 1 << (s - log_n), p)


def ntt(a: List[int], w: int, log_n: int, p: int) -> None:
    """In-place radix-2 NTT (halo2curves best_fft semantics)."""
    n = 1 << log_n
    assert len(a) == n
    if native.available() and n >= 64:
        arr = native.ints_to_limbs([v % p for v in a])
        a[:] = native.limbs_to_ints(native.ntt_l(p, arr, w))
        return
    # bit-reverse
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    m = 1
    while m < n:
        wm = pow(w, n // (2 * m), p)
        for k in range(0, n, 2 * m):
            cur = 1
            for j2 in range(m):
                t = cur * a[k + j2 + m] % p
                u = a[k + j2]
                a[k + j2] = (u + t) % p
                a[k + j2 + m] = (u - t) % p
                cur = cur * wm % p
        m *= 2


def _poly_eval(f: Sequence[int], x: int, p: int) -> int:
    if native.available() and len(f) >= 64:
        return native.poly_eval_horner_l(
            p, native.ints_to_limbs([c % p for c in f]), x
        )
    acc = 0
    for c in reversed(f):
        acc = (acc * x + c) % p
    return acc


def _div_linear(f: List[int], a: int, p: int) -> int:
    """In-place f(X) <- f(X)/(X-a) via Horner; returns remainder."""
    if native.available() and len(f) >= 64:
        fl = native.ints_to_limbs([c % p for c in f])
        rem = native.poly_eval_horner_l(p, fl, a)
        f[:] = native.limbs_to_ints(native.poly_div_linear_l(p, fl, a))
        return rem
    for i in range(len(f) - 2, -1, -1):
        f[i] = (f[i] + f[i + 1] * a) % p
    return f.pop(0)


def _mul_linear(f: List[int], a: int, p: int) -> List[int]:
    """f(X) * (X + a)."""
    out = [0] * (len(f) + 1)
    for i, c in enumerate(f):
        out[i] = (out[i] + c * a) % p
        out[i + 1] = (out[i + 1] + c) % p
    return out


def _interp(xs: List[int], ys: List[int], p: int) -> List[int]:
    """Lagrange interpolation for <=3 points (from_evals_with_xs)."""
    n = len(xs)
    if n == 1:
        return [ys[0] % p]
    coeffs = [0] * n
    for i in range(n):
        # basis poly prod_{j!=i} (X - xs[j]) / (xs[i] - xs[j])
        basis = [1]
        denom = 1
        for j2 in range(n):
            if j2 == i:
                continue
            basis = _mul_linear(basis, (-xs[j2]) % p, p)
            denom = denom * (xs[i] - xs[j2]) % p
        scale = ys[i] * pow(denom, -1, p) % p
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + scale * c) % p
    return coeffs


def eval_pu_poly(u: Sequence[int], r: int, p: int) -> int:
    """eq(u, power-basis r): prod (u_i r^{2^i} + 1 - u_i), u reversed
    (mercury.rs:358-366)."""
    res = 1
    for i, u_i in enumerate(reversed(list(u))):
        res = res * ((u_i * pow(r, 1 << i, p) + 1 - u_i) % p) % p
    return res


# ---------------------------------------------------------------------------
# Mercury-specific polynomial builders
# ---------------------------------------------------------------------------

def _divide_by_binomial(coeffs, num_rows, num_cols, alpha, p):
    """f(X) / (X^num_cols - alpha) -> (quotient, remainder)
    (mercury.rs:317-356)."""
    quotients = []
    remainder = []
    for col in range(num_cols):
        q = list(coeffs[col::num_cols])
        assert len(q) == num_rows
        rem = _div_linear(q, alpha, p) if len(q) > 1 else q.pop(0)
        q += [0] * (num_cols - len(q))
        quotients.append(q)
        remainder.append(rem)
    # transpose (num_rows x num_cols layout)
    b = num_cols
    flat = []
    for q in quotients:
        flat.extend(q + [0] * (b - len(q)))
    quotient = []
    for c in range(b):
        quotient.extend(flat[c::b])
    while quotient and quotient[-1] == 0:
        quotient.pop()
    return quotient, remainder


def _compute_h_poly(f_poly, eq_col, num_rows, num_cols, p):
    return [
        sum(f_poly[r * num_cols + c] * eq_col[c] for c in range(num_cols)) % p
        for r in range(num_rows)
    ]


def _make_s_polynomial(a_polys, b_polys, log_b, gamma, p):
    """(mercury.rs:389-477): s(X) from the product relation via NTT."""
    b = 1 << log_b
    b2 = 2 * b
    w = omega(p, log_b + 1)
    a1, a2 = [list(v) for v in a_polys]
    b1, b2v = [list(v) for v in b_polys]
    evals4 = []
    for v in (a1, a2, b1, b2v):
        vv = list(v) + [0] * (b2 - len(v))
        ntt(vv, w, log_b + 1, p)
        evals4.append(vv)
    ae1, ae2, be1, be2 = evals4

    evals = [0] * b2
    evals[0] = 2 * (ae1[0] * be1[0] + ae2[0] * be2[0] % p * gamma) % p
    for i in range(1, b2):
        s1 = ae1[i] * be1[b2 - i] + ae1[b2 - i] * be1[i]
        s2 = ae2[i] * be2[b2 - i] + ae2[b2 - i] * be2[i]
        evals[i] = (s1 + s2 * gamma) % p

    # multiply by X^{b-1} in evaluation form
    wn1 = pow(w, b - 1, p)
    cur = wn1
    for i in range(1, b2):
        evals[i] = evals[i] * cur % p
        cur = cur * wn1 % p

    ntt(evals, pow(w, -1, p), log_b + 1, p)
    binv = pow(b2, -1, p)
    res = [x * binv % p for x in evals]
    while res and res[-1] == 0:
        res.pop()
    assert len(res) < b2
    return res[b:]


# ---------------------------------------------------------------------------
# the evaluation argument
# ---------------------------------------------------------------------------

@dataclass
class EvaluationArgument:
    comm_h: Commitment
    comm_g: Commitment
    comm_q: Commitment
    comm_s: Commitment
    comm_d: Commitment
    comm_quot_f: Commitment
    comm_w: Commitment
    comm_w_prime: Commitment
    g_zeta: int
    g_zeta_inv: int
    h_zeta: int
    h_zeta_inv: int
    s_zeta: int
    s_zeta_inv: int


def _absorb_comms(transcript, label, comms):
    transcript.absorb(label, b"".join(c.to_transcript_bytes() for c in comms))


def _absorb_scalars(transcript, label, field, vals):
    transcript.absorb(label, b"".join(field.to_repr(v % field.p) for v in vals))


class EvaluationEngine:
    """EvaluationEngineTrait (mercury.rs:875-1490); key shared with
    HyperKZG."""

    @staticmethod
    def setup(engine, ck: CommitmentKey, tau_H: G2Point = None):
        return KZG.setup(engine, ck, tau_H)

    # -- prover ---------------------------------------------------------------
    @staticmethod
    def prove(engine, ck: CommitmentKey, pk, transcript, comm, poly, point, eval_v):
        field = engine.scalar
        p = field.p

        _absorb_comms(transcript, L_F, [comm])
        _absorb_scalars(transcript, L_U, field, point)
        _absorb_scalars(transcript, L_E, field, [eval_v])

        original_size = len(poly)
        log_n = len(point)
        assert log_n > 1
        point = [x % p for x in point]
        f_poly = [x % p for x in poly]
        if log_n % 2 == 1:
            log_n += 1
            point.insert(0, 0)
            f_poly += [0] * ((1 << log_n) - len(f_poly))
        log_b = log_n // 2
        b = 1 << log_b
        b_row = original_size // b

        u_row, u_col = point[:log_b], point[log_b:]
        eq_row = EqPolynomial.evals_from_points(field, u_row)
        eq_col = EqPolynomial.evals_from_points(field, u_col)

        # Step 1: h(X)
        h_poly = _compute_h_poly(f_poly, eq_col, b_row, b, p)
        h_poly += [0] * (b - len(h_poly))
        comm_h = CE.commit(ck, h_poly, 0)
        _absorb_comms(transcript, L_H, [comm_h])

        # Step 2: alpha, q(X), g(X)
        alpha = transcript.squeeze(L_ALPHA)
        q_poly, g_poly = _divide_by_binomial(f_poly[:original_size], b_row, b, alpha, p)
        assert len(g_poly) == b
        comm_q = CE.commit(ck, q_poly if q_poly else [0], 0)
        comm_g = CE.commit(ck, g_poly, 0)
        _absorb_comms(transcript, L_Q, [comm_q])
        _absorb_comms(transcript, L_G, [comm_g])

        # Step 3: gamma, s(X), d(X)
        gamma = transcript.squeeze(L_GAMMA)
        s_poly = _make_s_polynomial((eq_col, eq_row), (g_poly, h_poly), log_b, gamma, p)
        d_poly = list(reversed(g_poly))
        comm_s = CE.commit(ck, s_poly if s_poly else [0], 0)
        comm_d = CE.commit(ck, d_poly, 0)
        _absorb_comms(transcript, L_S, [comm_s])
        _absorb_comms(transcript, L_D, [comm_d])

        # Step 4: zeta + evaluations
        zeta = transcript.squeeze(L_ZETA)
        zeta_inv = pow(zeta, -1, p)
        g_zeta = _poly_eval(g_poly, zeta, p)
        g_zeta_inv = _poly_eval(g_poly, zeta_inv, p)
        h_zeta = _poly_eval(h_poly, zeta, p)
        h_zeta_inv = _poly_eval(h_poly, zeta_inv, p)
        h_alpha = _poly_eval(h_poly, alpha, p)
        s_zeta = _poly_eval(s_poly, zeta, p)
        s_zeta_inv = _poly_eval(s_poly, zeta_inv, p)
        d_zeta = _poly_eval(d_poly, zeta, p)

        # quot_f = (f - q*(zeta^b - alpha) - g(zeta)) / (X - zeta)
        zeta_b_alpha = (pow(zeta, b, p) - alpha) % p
        quot_f = list(f_poly[:original_size])
        for i, qc in enumerate(q_poly):
            quot_f[i] = (quot_f[i] - zeta_b_alpha * qc) % p
        quot_f[0] = (quot_f[0] - g_zeta) % p
        rem = _div_linear(quot_f, zeta, p)
        assert rem == 0

        _absorb_scalars(transcript, L_GZ, field, [g_zeta])
        _absorb_scalars(transcript, L_GZI, field, [g_zeta_inv])
        _absorb_scalars(transcript, L_HZ, field, [h_zeta])
        _absorb_scalars(transcript, L_HZI, field, [h_zeta_inv])
        _absorb_scalars(transcript, L_SZ, field, [s_zeta])
        _absorb_scalars(transcript, L_SZI, field, [s_zeta_inv])

        while quot_f and quot_f[-1] == 0:
            quot_f.pop()
        comm_quot_f = CE.commit(ck, quot_f if quot_f else [0], 0)
        _absorb_comms(transcript, L_QUOT_F, [comm_quot_f])

        # Step 4(e): BDFG20 batch opening of (g, h, s, d)
        beta = transcript.squeeze(L_BETA)
        beta2, beta3 = beta * beta % p, beta * beta % p * beta % p

        g_star = _interp([zeta, zeta_inv], [g_zeta, g_zeta_inv], p)
        h_star = _interp([zeta, zeta_inv, alpha], [h_zeta, h_zeta_inv, h_alpha], p)
        s_star = _interp([zeta, zeta_inv], [s_zeta, s_zeta_inv], p)
        d_star = [d_zeta]

        def sub_poly(f, g):
            out = list(f) + [0] * max(0, len(g) - len(f))
            for i, c in enumerate(g):
                out[i] = (out[i] - c) % p
            return out

        gg = sub_poly(g_poly, g_star)
        hh = sub_poly(h_poly, h_star)
        ss = sub_poly(s_poly, s_star)
        dd = sub_poly(d_poly, d_star)
        # multiply by the vanishing complements Z_{T\S_i}
        gg = _mul_linear(gg, (-alpha) % p, p)
        ss = _mul_linear(ss, (-alpha) % p, p)
        dd = _mul_linear(_mul_linear(dd, (-alpha) % p, p), (-zeta_inv) % p, p)

        m_poly = list(gg) + [0] * max(0, max(len(hh), len(ss), len(dd)) - len(gg))
        for src, sc in ((hh, beta), (ss, beta2), (dd, beta3)):
            for i, c in enumerate(src):
                m_poly[i] = (m_poly[i] + sc * c) % p

        quot_m = m_poly
        for pt in (alpha, zeta, zeta_inv):
            rem = _div_linear(quot_m, pt, p)
            assert rem == 0

        comm_w = CE.commit(ck, quot_m if quot_m else [0], 0)
        _absorb_comms(transcript, L_W, [comm_w])

        z = transcript.squeeze(L_Z)

        t_s1_z = (z - alpha) % p
        t_s2_z = 1
        t_s3_z = t_s1_z
        t_s4_z = t_s1_z * ((z - zeta_inv) % p) % p
        t_z = t_s4_z * ((z - zeta) % p) % p

        def shift_const(f, star):
            out = list(f)
            out[0] = (out[0] - _poly_eval(star, z, p)) % p
            return out

        gz = shift_const(g_poly, g_star)
        hz = shift_const(h_poly, h_star)
        sz = shift_const(s_poly if s_poly else [0], s_star)
        dz = shift_const(d_poly, d_star)

        scalars = [t_s1_z, t_s2_z * beta % p, t_s3_z * beta2 % p, t_s4_z * beta3 % p]
        mlen = max(len(gz), len(hz), len(sz), len(dz), len(quot_m))
        l_poly = [0] * mlen
        for src, sc in zip((gz, hz, sz, dz), scalars):
            for i, c in enumerate(src):
                l_poly[i] = (l_poly[i] + sc * c) % p
        for i, c in enumerate(quot_m):
            l_poly[i] = (l_poly[i] - t_z * c) % p

        rem = _div_linear(l_poly, z, p)
        assert rem == 0
        comm_w_prime = CE.commit(ck, l_poly if l_poly else [0], 0)

        _absorb_comms(transcript, L_WP, [comm_w_prime])
        transcript.squeeze(L_PAIRING_D)

        return EvaluationArgument(
            comm_h=comm_h, comm_g=comm_g, comm_q=comm_q, comm_s=comm_s,
            comm_d=comm_d, comm_quot_f=comm_quot_f, comm_w=comm_w,
            comm_w_prime=comm_w_prime,
            g_zeta=g_zeta, g_zeta_inv=g_zeta_inv,
            h_zeta=h_zeta, h_zeta_inv=h_zeta_inv,
            s_zeta=s_zeta, s_zeta_inv=s_zeta_inv,
        )

    # -- verifier ---------------------------------------------------------------
    @staticmethod
    def verify(engine, vk: HyperKZGVerifierKey, transcript, comm, point, eval_v, arg):
        field = engine.scalar
        p = field.p

        _absorb_comms(transcript, L_F, [comm])
        _absorb_scalars(transcript, L_U, field, point)
        _absorb_scalars(transcript, L_E, field, [eval_v])
        _absorb_comms(transcript, L_H, [arg.comm_h])
        alpha = transcript.squeeze(L_ALPHA)
        _absorb_comms(transcript, L_Q, [arg.comm_q])
        _absorb_comms(transcript, L_G, [arg.comm_g])
        gamma = transcript.squeeze(L_GAMMA)
        _absorb_comms(transcript, L_S, [arg.comm_s])
        _absorb_comms(transcript, L_D, [arg.comm_d])
        zeta = transcript.squeeze(L_ZETA)
        _absorb_scalars(transcript, L_GZ, field, [arg.g_zeta])
        _absorb_scalars(transcript, L_GZI, field, [arg.g_zeta_inv])
        _absorb_scalars(transcript, L_HZ, field, [arg.h_zeta])
        _absorb_scalars(transcript, L_HZI, field, [arg.h_zeta_inv])
        _absorb_scalars(transcript, L_SZ, field, [arg.s_zeta])
        _absorb_scalars(transcript, L_SZI, field, [arg.s_zeta_inv])
        _absorb_comms(transcript, L_QUOT_F, [arg.comm_quot_f])

        point = [x % p for x in point]
        if len(point) % 2 == 1:
            point.insert(0, 0)
        log_n = len(point)
        u_row = point[: log_n // 2]
        u_col = point[log_n // 2:]

        zeta_inv = pow(zeta, -1, p)
        zeta_b_one = pow(zeta, (1 << (log_n // 2)) - 1, p)

        pu_col_zeta = eval_pu_poly(u_col, zeta, p)
        pu_col_zeta_inv = eval_pu_poly(u_col, zeta_inv, p)
        pu_row_zeta = eval_pu_poly(u_row, zeta, p)
        pu_row_zeta_inv = eval_pu_poly(u_row, zeta_inv, p)

        # implicit degree + IPA checks
        d_zeta = zeta_b_one * arg.g_zeta_inv % p
        h_alpha = (
            arg.g_zeta * pu_col_zeta_inv
            + arg.g_zeta_inv * pu_col_zeta
            + gamma * ((arg.h_zeta * pu_row_zeta_inv + arg.h_zeta_inv * pu_row_zeta
                        - 2 * eval_v) % p)
            - zeta * arg.s_zeta
            - zeta_inv * arg.s_zeta_inv
        ) % p
        h_alpha = h_alpha * pow(2, -1, p) % p

        # pairing 1: f/(X^b - alpha) division check
        zeta_b = zeta_b_one * zeta % p
        zeta_b_alpha = (zeta_b - alpha) % p
        ll1 = comm.point.add(
            host_msm(
                [(-zeta_b_alpha) % p, (-arg.g_zeta) % p, zeta],
                [arg.comm_q.point, vk.G, arg.comm_quot_f.point],
            )
        )
        rl1 = arg.comm_quot_f.point

        # pairing 2: BDFG batch evaluation (extract_pairing_to_verify...)
        beta = transcript.squeeze(L_BETA)
        beta2, beta3 = beta * beta % p, beta * beta % p * beta % p
        _absorb_comms(transcript, L_W, [arg.comm_w])
        z = transcript.squeeze(L_Z)

        g_star = _interp([zeta, zeta_inv], [arg.g_zeta, arg.g_zeta_inv], p)
        h_star = _interp([zeta, zeta_inv, alpha], [arg.h_zeta, arg.h_zeta_inv, h_alpha], p)
        s_star = _interp([zeta, zeta_inv], [arg.s_zeta, arg.s_zeta_inv], p)
        d_star = [d_zeta]

        van_zeta = (z - zeta) % p
        van_zeta_inv = (z - zeta_inv) % p
        van_alpha = (z - alpha) % p
        z_t_s1 = van_alpha
        z_t_s2 = 1
        z_t_s3 = van_alpha
        z_t_s4 = van_zeta_inv * van_alpha % p
        z_t = z_t_s4 * van_zeta % p

        scalar = (
            z_t_s1 * _poly_eval(g_star, z, p)
            + beta * z_t_s2 % p * _poly_eval(h_star, z, p)
            + beta2 * z_t_s3 % p * _poly_eval(s_star, z, p)
            + beta3 * z_t_s4 % p * _poly_eval(d_star, z, p)
        ) % p
        scalars = [
            z_t_s1, beta * z_t_s2 % p, beta2 * z_t_s3 % p, beta3 * z_t_s4 % p,
            (-scalar) % p, (-z_t) % p, z,
        ]
        bases = [
            arg.comm_g.point, arg.comm_h.point, arg.comm_s.point, arg.comm_d.point,
            vk.G, arg.comm_w.point, arg.comm_w_prime.point,
        ]
        ll2 = host_msm(scalars, bases)
        rl2 = arg.comm_w_prime.point

        _absorb_comms(transcript, L_WP, [arg.comm_w_prime])
        d = transcript.squeeze(L_PAIRING_D)

        ll = ll1.add(ll2.mul(d))
        rl = rl1.add(rl2.mul(d))

        # e(ll, [1]_2) == e(rl, [tau]_2)
        if not multi_pairing_is_one([(ll, vk.H), (rl.neg(), vk.tau_H)]):
            raise ProofVerifyError("Mercury pairing check failed")
