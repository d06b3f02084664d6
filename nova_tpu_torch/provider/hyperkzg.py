"""HyperKZG: KZG-based multilinear PCS (port of ``nova_tpu/provider/hyperkzg.py``;
reference: src/provider/hyperkzg.rs).

Gemini-style multilinear-to-univariate reduction in evaluation form (no
FFT): fold the evaluation table ell-1 times with the point coordinates,
commit each fold, open the q-batched polynomial at {r, -r, r^2} with three
KZG witnesses, verify with one pairing equation (2 pairings).

The commitment key is powers-of-tau in G1 (reuses the Pedersen
CommitmentKey container: ck[i] = tau^i * G) plus tau_H in G2 for the
verifier. Production setup must come from a ptau ceremony file
(provider/ptau.py); `setup_from_tau` / `setup_insecure` mirror the
reference's test-utils-gated paths (hyperkzg.rs:357-456, 565-578).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from nova_tpu_torch.curves.pairing import G2Point, multi_pairing_is_one
from nova_tpu_torch.curves.spec import AffinePoint, bn254
from nova_tpu_torch.errors import NovaError, ProofVerifyError
from nova_tpu_torch.provider.pedersen import Commitment, CommitmentEngine as CE, CommitmentKey


@dataclass
class HyperKZGVerifierKey:
    G: AffinePoint
    H: G2Point
    tau_H: G2Point


@dataclass
class HyperKZGProverKey:
    pass


@dataclass
class EvaluationArgument:
    com: List[Commitment]          # ell-1 fold commitments
    w: List[Commitment]            # 3 KZG witnesses
    v: List[List[int]]             # ell rows of (f_i(r), f_i(-r), f_i(r^2))


def setup_from_tau(tau: int, n: int, device=None) -> Tuple[CommitmentKey, G2Point]:
    """Powers-of-tau key over BN254 G1 + tau_H in G2, its device MSMs on
    `device` (CUDA unless given). INSECURE unless tau is discarded toxic
    waste (reference gates this behind test-utils; production keys load
    from ptau files)."""
    n_pow2 = 1 if n <= 1 else 1 << (n - 1).bit_length()
    from nova_tpu_torch import native

    g = AffinePoint.generator(bn254)
    r = bn254.scalar.p
    powers = []
    cur = 1
    for _ in range(n_pow2):
        powers.append(cur)
        cur = cur * tau % r
    if native.available():
        # fixed-base window tables: one shared precompute, 32 mixed adds
        # per power (reference fixed_base_exp_comb_batch, hyperkzg.rs:443)
        pts = native.ec_fixed_mul_many(g, powers)
    else:
        pts = [g.mul(s) for s in powers]
    # blinding generator from hash-to-curve, never a known multiple of G
    # (a public discrete log of h w.r.t. G breaks Pedersen binding of
    # blinded commitments; reference hyperkzg.rs:386,672 uses from_label)
    from nova_tpu_torch.provider.pedersen import from_label

    h = from_label(bn254, b"h", 1)[0]
    ck = CommitmentKey(bn254, pts, h, device=device)
    tau_H = G2Point.generator().mul(tau)
    ck._tau_H = tau_H  # travels with the key so EE.setup can find it
    return ck, tau_H


def setup_insecure(n: int, device=None) -> Tuple[CommitmentKey, G2Point]:
    """Random-tau setup for tests (hyperkzg.rs setup_from_rng)."""
    return setup_from_tau(secrets.randbelow(bn254.scalar.p), n, device)


class EvaluationEngine:
    """EvaluationEngineTrait impl (hyperkzg.rs:897-1240). The engine object
    carries tau_H via its verifier key; `engine` must be a BN254 engine."""

    tau_H: G2Point = None  # set via setup(..., tau_H=...)

    @staticmethod
    def setup(engine, ck: CommitmentKey, tau_H: G2Point = None):
        tau_H = tau_H if tau_H is not None else getattr(ck, "_tau_H", None)
        if tau_H is None:
            raise NovaError(
                "HyperKZG setup requires a powers-of-tau key with tau_H "
                "(load from ptau or use setup_insecure for tests)"
            )
        pk = HyperKZGProverKey()
        vk = HyperKZGVerifierKey(
            G=AffinePoint.generator(bn254), H=G2Point.generator(), tau_H=tau_H
        )
        return pk, vk

    # -- Fiat-Shamir helpers (hyperkzg.rs:857-894) --------------------------
    @staticmethod
    def _compute_challenge(com: List[Commitment], transcript) -> int:
        transcript.absorb(b"c", b"".join(c.to_transcript_bytes() for c in com))
        return transcript.squeeze(b"c")

    @staticmethod
    def _get_batch_challenge(field, v: List[List[int]], transcript) -> int:
        flat = b""
        for row in v:
            for x in row:
                flat += field.to_repr(x % field.p)
        transcript.absorb(b"v", flat)
        return transcript.squeeze(b"r")

    @staticmethod
    def _verifier_second_challenge(W: List[Commitment], transcript) -> int:
        transcript.absorb(b"W", b"".join(c.to_transcript_bytes() for c in W))
        return transcript.squeeze(b"d")

    # -- prover ---------------------------------------------------------------
    @staticmethod
    def prove(engine, ck: CommitmentKey, pk, transcript, C, hat_P, point, eval_v):
        field = engine.scalar
        p = field.p
        x = [xi % p for xi in point]
        ell = len(x)
        n = len(hat_P)
        assert n == 1 << ell
        from nova_tpu_torch import native

        if native.available() and ell >= 2:
            return EvaluationEngine._prove_limbs(
                field, ck, transcript, hat_P, x, native
            )

        def kzg_open(f: Sequence[int], u: int) -> Commitment:
            # h(x) = f(x) / (x - u) via Horner
            d = len(f)
            h = [0] * d
            for i in range(d - 1, 0, -1):
                h[i - 1] = (f[i] + h[i] * u) % p
            return CE.commit(ck, h[: d - 1] if d > 1 else [0], 0)

        def poly_eval(f: Sequence[int], u: int) -> int:
            acc = 0
            for fi in reversed(f):
                acc = (acc * u + fi) % p
            return acc

        # Phase 1: fold polynomials
        polys = [list(hat_P)]
        for i in range(ell - 1):
            prev = polys[i]
            xi = x[ell - i - 1]
            Pi = [
                (xi * (prev[2 * j + 1] - prev[2 * j]) + prev[2 * j]) % p
                for j in range(len(prev) // 2)
            ]
            polys.append(Pi)

        com = [CE.commit(ck, poly, 0) for poly in polys[1:]]

        # Phase 2
        r = EvaluationEngine._compute_challenge(com, transcript)
        u = [r, (-r) % p, r * r % p]

        # Phase 3: batched KZG openings
        v = [[poly_eval(f, ui) for ui in u] for f in polys]
        q = EvaluationEngine._get_batch_challenge(field, v, transcript)

        B = list(polys[0]) + [0] * 0
        qp = 1
        for i in range(1, len(polys)):
            qp = qp * q % p
            for j, fj in enumerate(polys[i]):
                B[j] = (B[j] + qp * fj) % p

        w = [kzg_open(B, ui) for ui in u]
        EvaluationEngine._verifier_second_challenge(w, transcript)

        return EvaluationArgument(com=com, w=w, v=v)

    @staticmethod
    def _prove_limbs(field, ck, transcript, hat_P, x, native):
        """Limb-array prover path: folds via the fused fold kernel, Horner
        evals and synthetic KZG divisions in C, commits through the cached
        marshalled key (the rayon-parallel structure of
        hyperkzg.rs:897-1100 mapped onto the host-native kernels)."""
        import numpy as np

        p = field.p
        ell = len(x)
        from nova_tpu_torch.ops.fvec import HVec

        if isinstance(hat_P, HVec):
            P0 = hat_P.limbs64()
        elif isinstance(hat_P, np.ndarray):
            P0 = hat_P
        else:
            P0 = native.ints_to_limbs([v % p for v in hat_P])

        # Phase 1: fold adjacent pairs with x coordinates, commit each fold
        polys = [P0]
        for i in range(ell - 1):
            prev = polys[i]
            xi = x[ell - i - 1]
            ev = np.ascontiguousarray(prev[0::2])
            od = np.ascontiguousarray(prev[1::2])
            polys.append(native.vec_fold_l(p, ev, od, (1 - xi) % p, xi % p))
        com = [CE.commit_limbs(ck, poly, 0) for poly in polys[1:]]

        # Phase 2: eval points {r, -r, r^2}
        r = EvaluationEngine._compute_challenge(com, transcript)
        u = [r, (-r) % p, r * r % p]

        # Phase 3: batched KZG openings
        v = [
            [native.poly_eval_horner_l(p, f, ui) for ui in u] for f in polys
        ]
        q = EvaluationEngine._get_batch_challenge(field, v, transcript)

        B = polys[0].copy()
        qp = 1
        for i in range(1, len(polys)):
            qp = qp * q % p
            m = polys[i].shape[0]
            B[:m] = native.vec_axpy_l(p, np.ascontiguousarray(B[:m]), polys[i], qp)

        def kzg_open_l(f: np.ndarray, ui: int) -> Commitment:
            if f.shape[0] < 2:
                return CE.commit(ck, [0], 0)
            return CE.commit_limbs(ck, native.poly_div_linear_l(p, f, ui), 0)

        w = [kzg_open_l(B, ui) for ui in u]
        EvaluationEngine._verifier_second_challenge(w, transcript)
        return EvaluationArgument(com=com, w=w, v=v)

    # -- verifier ---------------------------------------------------------------
    @staticmethod
    def verify(engine, vk: HyperKZGVerifierKey, transcript, C, x, y, pi: EvaluationArgument):
        field = engine.scalar
        p = field.p
        ell = len(x)

        r = EvaluationEngine._compute_challenge(pi.com, transcript)
        u = [r, (-r) % p, r * r % p]

        if len(pi.v) != ell or len(pi.com) != ell - 1:
            raise ProofVerifyError("Invalid lengths of pi.v")

        for i in range(ell):
            ypos = pi.v[i][0]
            yneg = pi.v[i][1]
            Y = pi.v[i + 1][2] if i + 1 < ell else (y % p)
            lhs = 2 * r % p * Y % p
            xi = x[ell - i - 1] % p
            rhs = (r * (1 - xi) % p * ((ypos + yneg) % p) + xi * ((ypos - yneg) % p)) % p
            if lhs != rhs:
                raise ProofVerifyError("Inconsistent (Y, ypos, yneg)")

        q = EvaluationEngine._get_batch_challenge(field, pi.v, transcript)
        d_0 = EvaluationEngine._verifier_second_challenge(pi.w, transcript)
        d_1 = d_0 * d_0 % p

        q_mult = (1 + d_0 + d_1) % p
        q_powers_multiplied = []
        cur = q_mult
        for _ in range(ell):
            q_powers_multiplied.append(cur)
            cur = cur * q % p

        B_u = []
        for i in range(3):
            acc = 0
            for v_j in reversed(pi.v):
                acc = (acc * q + v_j[i]) % p
            B_u.append(acc)

        scalars = (
            q_powers_multiplied
            + [u[0], u[1] * d_0 % p, u[2] * d_1 % p,
               (-(B_u[0] + d_0 * B_u[1] + d_1 * B_u[2])) % p]
        )
        bases = (
            [C.point] + [c.point for c in pi.com] + [c.point for c in pi.w] + [vk.G]
        )
        from nova_tpu_torch.curves.msm_host import msm as host_msm

        L = host_msm(scalars, bases)
        R = pi.w[0].point.add(pi.w[1].point.mul(d_0)).add(pi.w[2].point.mul(d_1))

        # e(L, H) == e(R, tau_H)  <=>  e(L, H) * e(-R, tau_H) == 1
        if not multi_pairing_is_one([(L, vk.H), (R.neg(), vk.tau_H)]):
            raise ProofVerifyError("Pairing check failed")
