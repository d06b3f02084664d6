"""The Nova IVC engine: NIFS folding, the augmented circuit, PublicParams,
RecursiveSNARK, and CompressedSNARK (reference: src/nova/)."""

from nova_tpu_torch.nova.nifs import NIFS, NIFSRelaxed

__all__ = ["NIFS", "NIFSRelaxed"]
