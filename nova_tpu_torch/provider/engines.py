"""Engine bundles: the seven concrete engines of the reference
(src/provider/mod.rs:38-148), each tying together a curve, its two fields,
the Poseidon ROs (base-field RO + scalar-field RO2), the Keccak transcript,
and a commitment engine.

An Engine here is a lightweight singleton object (the Rust version is a
zero-sized type with associated types)."""

from __future__ import annotations

from nova_tpu_torch.curves.spec import (
    CurveSpec,
    pallas,
    vesta,
    bn254,
    grumpkin,
    secp256k1,
    secq256k1,
)
from nova_tpu_torch.provider.keccak import Keccak256Transcript
from nova_tpu_torch.provider.poseidon import PoseidonRO, PoseidonROConstants


class Engine:
    """An engine: curve + field pair + RO constants + commitment engine.

    - ``base``/``scalar``: FieldSpecs (E::Base / E::Scalar)
    - ``curve``: the group (E::GE)
    - ``commitment_engine``: 'pedersen' or 'hyperkzg'
    """

    _registry: dict = {}

    def __init__(self, name: str, curve: CurveSpec, commitment_engine: str = "pedersen"):
        self.name = name
        self.curve = curve
        self.base = curve.base
        self.scalar = curve.scalar
        self.commitment_engine = commitment_engine
        Engine._registry[name] = self

    # Poseidon RO over the BASE field (E::RO): hashes commitments' coordinates.
    def ro_constants(self) -> PoseidonROConstants:
        return PoseidonROConstants(self.base)

    # Poseidon RO over the SCALAR field (E::RO2).
    def ro2_constants(self) -> PoseidonROConstants:
        return PoseidonROConstants(self.scalar)

    def new_ro(self, mode: str = "wide") -> PoseidonRO:
        return PoseidonRO(self.ro_constants(), mode)

    def new_ro2(self, mode: str = "wide") -> PoseidonRO:
        return PoseidonRO(self.ro2_constants(), mode)

    def new_transcript(self, label: bytes) -> Keccak256Transcript:
        return Keccak256Transcript(label, self.scalar)

    def __repr__(self):
        return f"<Engine {self.name}>"


PallasEngine = Engine("PallasEngine", pallas)
VestaEngine = Engine("VestaEngine", vesta)
Bn256EngineIPA = Engine("Bn256EngineIPA", bn254)
Bn256EngineKZG = Engine("Bn256EngineKZG", bn254, commitment_engine="hyperkzg")
GrumpkinEngine = Engine("GrumpkinEngine", grumpkin)
Secp256k1Engine = Engine("Secp256k1Engine", secp256k1)
Secq256k1Engine = Engine("Secq256k1Engine", secq256k1)
