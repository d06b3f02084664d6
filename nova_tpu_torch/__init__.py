"""nova_tpu_torch: the PyTorch/CUDA port of ``nova_tpu``.

A second package beside ``nova_tpu`` that runs the prover's device paths
on an NVIDIA H100 with PyTorch tensors and CUDA kernels written by hand
for Hopper (``csrc/``, built by ``nvcc`` at first use, see ``_build.py``).
It imports neither ``jax`` nor ``nova_tpu``: host-only modules it needs
are its own copies.

Ported so far (the device Pedersen commit):

- ``fields``   -- field specs (host ints) and ``TField``, the 16-bit-limb
  Montgomery engine on ``(N, 16)`` int32 tensors; kernels K1-K3.
- ``curves``   -- curve specs, the host Pippenger oracle, XYZZ points.
- ``ops``      -- ``FVec`` and the fixed-base MSM (``msm3``; kernels K4, K5).
- ``provider`` -- Keccak/Shake256, hash-to-curve and the Pedersen engine.
- ``interop``  -- numpy arrays of the JAX package's state -> port objects.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"

from nova_tpu_torch import constants, errors  # noqa: F401,E402
