"""CompressedSNARK: ZK compression of a RecursiveSNARK (port of
``nova_tpu/nova/compressed.py``; reference: src/nova/mod.rs:676-1025).

Three foldings (fold in the last secondary instance, then fold a random
relaxed pair on each curve for zero-knowledge), derandomize, then run a
Spartan SNARK per curve on the derandomized running instances. With
NOVA_PROFILE=1 ``prove`` records the phases ``compress_nifs``,
``compress_randomizers`` and, inside each Spartan proof, ``spartan_outer``,
``spartan_inner``, ``spartan_batch_eval`` and ``spartan_ipa``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from nova_tpu_torch import profiling
from nova_tpu_torch.constants import NUM_HASH_BITS
from nova_tpu_torch.errors import ProofVerifyError
from nova_tpu_torch.nova.ivc import PublicParams, RecursiveSNARK
from nova_tpu_torch.nova.nifs import NIFS, NIFSRelaxed
from nova_tpu_torch.provider.pedersen import CommitmentEngine as CE
from nova_tpu_torch.spartan.snark import RelaxedR1CSSNARK


@dataclass
class CompressedProverKey:
    pk_primary: object
    pk_secondary: object
    S1: object = None  # SNARK class used at setup (binds prove to setup)
    S2: object = None


@dataclass
class CompressedVerifierKey:
    F_arity: int
    pp_digest: int
    vk_primary: object
    vk_secondary: object
    dk_primary: object
    dk_secondary: object
    engine1: object
    engine2: object


class CompressedSNARK:
    """src/nova/mod.rs:718-752 (fields), 793-906 (prove), 909-1025
    (verify). S1/S2 default to the non-preprocessing Spartan SNARK."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @staticmethod
    def setup(pp: PublicParams, S1=None, S2=None, ee1=None, ee2=None):
        S1 = S1 or RelaxedR1CSSNARK
        S2 = S2 or RelaxedR1CSSNARK
        pk_primary, vk_primary = S1.setup(
            pp.engine1, pp.ck_primary, pp.r1cs_shape_primary, ee=ee1
        )
        pk_secondary, vk_secondary = S2.setup(
            pp.engine2, pp.ck_secondary, pp.r1cs_shape_secondary, ee=ee2
        )
        pk = CompressedProverKey(pk_primary, pk_secondary, S1, S2)
        vk = CompressedVerifierKey(
            F_arity=pp.F_arity,
            pp_digest=pp.digest(),
            vk_primary=vk_primary,
            vk_secondary=vk_secondary,
            dk_primary=CE.derand_key(pp.ck_primary),
            dk_secondary=CE.derand_key(pp.ck_secondary),
            engine1=pp.engine1,
            engine2=pp.engine2,
        )
        return pk, vk

    @staticmethod
    def prove(
        pp: PublicParams,
        pk: CompressedProverKey,
        rs: RecursiveSNARK,
        S1=None,
        S2=None,
    ) -> "CompressedSNARK":
        S1 = S1 or pk.S1 or RelaxedR1CSSNARK
        S2 = S2 or pk.S2 or RelaxedR1CSSNARK
        e1, e2 = pp.engine1, pp.engine2
        S_p, S_s = pp.r1cs_shape_primary, pp.r1cs_shape_secondary

        # fold secondary U/W with secondary u/w to get Uf/Wf
        with profiling.phase("compress_nifs"):
            nifs_Uf_secondary, (r_Uf_secondary, r_Wf_secondary) = NIFS.prove(
                pp.ck_secondary, e2, pp.digest(), S_s,
                rs.r_U_secondary, rs.r_W_secondary, rs.l_u_secondary, rs.l_w_secondary,
            )

        # fold a random relaxed pair into each running instance (ZK)
        with profiling.phase("compress_randomizers"):
            l_ur_secondary, l_wr_secondary = S_s.sample_random_instance_witness(
                pp.ck_secondary)
        with profiling.phase("compress_nifs"):
            nifs_Un_secondary, (r_Un_secondary, r_Wn_secondary) = NIFSRelaxed.prove(
                pp.ck_secondary, e2, pp.digest(), S_s,
                r_Uf_secondary, r_Wf_secondary, l_ur_secondary, l_wr_secondary,
            )
        with profiling.phase("compress_randomizers"):
            l_ur_primary, l_wr_primary = S_p.sample_random_instance_witness(pp.ck_primary)
        with profiling.phase("compress_nifs"):
            nifs_Un_primary, (r_Un_primary, r_Wn_primary) = NIFSRelaxed.prove(
                pp.ck_primary, e1, pp.digest(), S_p,
                rs.r_U_primary, rs.r_W_primary, l_ur_primary, l_wr_primary,
            )

        # derandomize
        derandom_r_Wn_primary, wit_blind_p, err_blind_p = r_Wn_primary.derandomize()
        derandom_r_Un_primary = r_Un_primary.derandomize(
            CE.derand_key(pp.ck_primary), wit_blind_p, err_blind_p
        )
        derandom_r_Wn_secondary, wit_blind_s, err_blind_s = r_Wn_secondary.derandomize()
        derandom_r_Un_secondary = r_Un_secondary.derandomize(
            CE.derand_key(pp.ck_secondary), wit_blind_s, err_blind_s
        )

        snark_primary = S1.prove(
            e1, pp.ck_primary, pk.pk_primary, S_p,
            derandom_r_Un_primary, derandom_r_Wn_primary,
        )
        snark_secondary = S2.prove(
            e2, pp.ck_secondary, pk.pk_secondary, S_s,
            derandom_r_Un_secondary, derandom_r_Wn_secondary,
        )

        return CompressedSNARK(
            r_U_secondary=rs.r_U_secondary,
            ri_secondary=rs.ri_secondary,
            l_u_secondary=rs.l_u_secondary,
            nifs_Uf_secondary=nifs_Uf_secondary,
            l_ur_secondary=l_ur_secondary,
            nifs_Un_secondary=nifs_Un_secondary,
            r_U_primary=rs.r_U_primary,
            ri_primary=rs.ri_primary,
            l_ur_primary=l_ur_primary,
            nifs_Un_primary=nifs_Un_primary,
            wit_blind_r_Wn_primary=wit_blind_p,
            err_blind_r_Wn_primary=err_blind_p,
            wit_blind_r_Wn_secondary=wit_blind_s,
            err_blind_r_Wn_secondary=err_blind_s,
            snark_primary=snark_primary,
            snark_secondary=snark_secondary,
            zn=list(rs.zi),
        )

    def verify(self, vk: CompressedVerifierKey, num_steps: int, z0: Sequence[int]) -> List[int]:
        if num_steps == 0:
            raise ProofVerifyError("Number of steps cannot be zero")
        if any(len(U.X) != 2 for U in (self.l_u_secondary, self.r_U_primary,
                                       self.r_U_secondary, self.l_ur_primary,
                                       self.l_ur_secondary)):
            raise ProofVerifyError("Invalid number of outputs in R1CS instances")

        e1, e2 = vk.engine1, vk.engine2

        hasher = e2.new_ro()
        hasher.absorb(vk.pp_digest)
        hasher.absorb(num_steps)
        for e in z0:
            hasher.absorb(e)
        for e in self.zn:
            hasher.absorb(e)
        self.r_U_secondary.absorb_in_ro(hasher)
        hasher.absorb(self.ri_primary)
        hash_primary = hasher.squeeze(NUM_HASH_BITS, False)

        hasher2 = e1.new_ro()
        hasher2.absorb(vk.pp_digest)
        hasher2.absorb(num_steps)
        hasher2.absorb(0)
        hasher2.absorb(0)
        self.r_U_primary.absorb_in_ro(hasher2)
        hasher2.absorb(self.ri_secondary)
        hash_secondary = hasher2.squeeze(NUM_HASH_BITS, False)

        if (
            hash_primary != self.l_u_secondary.X[0]
            or hash_secondary != self.l_u_secondary.X[1]
        ):
            raise ProofVerifyError("Invalid output hash in R1CS instances")

        r_Uf_secondary = self.nifs_Uf_secondary.verify(
            e2, vk.pp_digest, self.r_U_secondary, self.l_u_secondary
        )
        r_Un_secondary = self.nifs_Un_secondary.verify(
            e2, vk.pp_digest, r_Uf_secondary, self.l_ur_secondary
        )
        r_Un_primary = self.nifs_Un_primary.verify(
            e1, vk.pp_digest, self.r_U_primary, self.l_ur_primary
        )

        derandom_r_Un_primary = r_Un_primary.derandomize(
            vk.dk_primary, self.wit_blind_r_Wn_primary, self.err_blind_r_Wn_primary
        )
        derandom_r_Un_secondary = r_Un_secondary.derandomize(
            vk.dk_secondary, self.wit_blind_r_Wn_secondary, self.err_blind_r_Wn_secondary
        )

        self.snark_primary.verify(vk.vk_primary, derandom_r_Un_primary)
        self.snark_secondary.verify(vk.vk_secondary, derandom_r_Un_secondary)

        return list(self.zn)
