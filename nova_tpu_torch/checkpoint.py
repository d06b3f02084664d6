"""Checkpoint/resume for IVC state (port of ``nova_tpu/checkpoint.py``;
SURVEY.md §5; reference: serde on RecursiveSNARK / PublicParams,
src/nova/mod.rs:319-320). The files and proof bytes are the JAX
package's.

Restartability is inherent to IVC — prover work per update is independent
of history — so checkpointing is just serializing the RecursiveSNARK after
any step. The public-parameter digest is stored alongside and re-checked on
resume, so a checkpoint resumed against mismatched parameters fails fast
(the reference achieves the same by binding pp.digest() into every hash).

Format: a versioned header + the typed structural encoding of
``serde`` (checkpoints and proofs are adversarial inputs, so no
pickle: decoding never executes constructors and validates every curve
point). Pedersen commitment keys round-trip separately via save_ck/load_ck
with the reference's PEDERSEN_KEY-style header.

Field vectors are written as int lists, so a running witness held on the
card comes back as lists; `load_recursive_snark` puts each running witness
that folds on the device (``RelaxedR1CSWitness._dev_fold``) back on its
key's device as the prover held it, so a resumed prove_step takes the
unbroken run's routes on ``pp``'s devices.
"""

from __future__ import annotations

import struct
from typing import Tuple

from nova_tpu_torch import serde
from nova_tpu_torch.errors import NovaError

_MAGIC = b"NOVATPU1"
_CK_HEADER = b"PEDERSEN_KEY"


def save_recursive_snark(path: str, pp, rs) -> None:
    """Checkpoint an IVC computation after any step."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        # underscore fields are runtime caches (e.g. compiled witness
        # tapes) — not part of the proof state, and not serializable
        state = {k: v for k, v in rs.__dict__.items() if not k.startswith("_")}
        blob = serde.dumps({"pp_digest": pp.digest(), "i": rs.i, "state": state})
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)


def load_recursive_snark(path: str, pp):
    """Resume; raises if the checkpoint was produced under different
    public parameters."""
    from nova_tpu_torch.fields.tfield import TField
    from nova_tpu_torch.nova.ivc import RecursiveSNARK
    from nova_tpu_torch.ops.fvec import FVec

    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise NovaError("bad checkpoint magic")
        (n,) = struct.unpack("<Q", f.read(8))
        d = serde.loads(f.read(n))
    if d["pp_digest"] != pp.digest():
        raise NovaError(
            "checkpoint was created under different public parameters "
            "(digest mismatch)"
        )
    rs = RecursiveSNARK.__new__(RecursiveSNARK)
    rs.__dict__.update(d["state"])
    rs._wgen_primary = None
    rs._wgen_secondary = None
    for name, engine, ck in (("r_W_primary", pp.engine1, pp.ck_primary),
                             ("r_W_secondary", pp.engine2, pp.ck_secondary)):
        W = getattr(rs, name)
        if W._dev_fold():
            tf = TField(engine.scalar)
            W.W = FVec.coerce(tf, W.W, ck.device)
            W.E = FVec.coerce(tf, W.E, ck.device)
    return rs


def save_ck(path: str, ck) -> None:
    """Pedersen key save (reference: pedersen.rs:317-393, PEDERSEN_KEY
    header + point count + raw points)."""
    with open(path, "wb") as f:
        f.write(_CK_HEADER)
        f.write(struct.pack("<Q", len(ck.ck)))
        for pt in ck.ck + [ck.h]:
            x, y, inf = pt.to_coordinates()
            f.write(x.to_bytes(32, "little"))
            f.write(y.to_bytes(32, "little"))
            f.write(b"\x01" if inf else b"\x00")


def load_ck(path: str, curve, device=None):
    """The key saved by save_ck, its device MSMs on `device` (CUDA unless
    given); every point is checked on the curve."""
    from nova_tpu_torch._device import resolve
    from nova_tpu_torch.curves.spec import AffinePoint
    from nova_tpu_torch.provider.pedersen import CommitmentKey

    with open(path, "rb") as f:
        if f.read(len(_CK_HEADER)) != _CK_HEADER:
            raise NovaError("bad commitment key header")
        (n,) = struct.unpack("<Q", f.read(8))
        pts = []
        for _ in range(n + 1):
            x = int.from_bytes(f.read(32), "little")
            y = int.from_bytes(f.read(32), "little")
            inf = f.read(1) == b"\x01"
            if inf:
                pts.append(AffinePoint.identity(curve))
            else:
                pt = AffinePoint(curve, x, y)
                if not pt.is_on_curve():
                    raise NovaError("off-curve point in commitment key")
                pts.append(pt)
    return CommitmentKey(curve, pts[:-1], pts[-1], device=resolve(device))


def proof_to_bytes(proof) -> bytes:
    """Serialize any proof object (CompressedSNARK, Spartan proofs,
    evaluation arguments) with the typed structural encoding."""
    return _MAGIC + serde.dumps(proof)


def proof_from_bytes(data: bytes):
    """Typed decode: never executes constructors, validates points."""
    if data[:8] != _MAGIC:
        raise NovaError("bad proof encoding")
    return serde.loads(data[8:])
