"""nova_tpu_torch: the PyTorch/CUDA port of ``nova_tpu``.

A second package beside ``nova_tpu`` that runs the prover's device paths
on an NVIDIA H100 with PyTorch tensors and CUDA kernels written by hand
for Hopper (``csrc/``, built by ``nvcc`` at first use, see ``_build.py``).
It imports neither ``jax`` nor ``nova_tpu``: host-only modules it needs
are its own copies.

Ported so far (the device Pedersen commit, the IVC fold step and its
compression):

- ``fields``   -- field specs (host ints) and ``TField``, the 16-bit-limb
  Montgomery engine on ``(N, 16)`` int32 tensors; kernels K1-K3.
- ``curves``   -- curve specs, the host Pippenger, XYZZ points.
- ``ops``      -- ``FVec``, the fixed-base MSM (``msm3``; kernels K4, K5),
  the int-scalar MSM (``msm2.msm_device2``; kernel B6), SpMV and folds,
  the device outer sumcheck (``sumcheck``).
- ``provider`` -- Keccak (Shake256, the transcript), hash-to-curve,
  Poseidon, the engines, the Pedersen engine and IPA.
- ``native``   -- the ctypes binding of the C++ host kernels
  (``native/nova_native.cpp``, built with g++ into ``_build/``).
- ``spartan``  -- polynomials, sumchecks, batch evaluation and the
  RelaxedR1CSSNARK.
- ``r1cs``, ``frontend``, ``gadgets``, ``nova`` -- the R1CS layer, the
  constraint-system frontend, the in-circuit gadgets, NIFS, the augmented
  circuit, ``PublicParams``/``RecursiveSNARK`` and ``CompressedSNARK``.
- ``perf``     -- the field microbenchmark (kernels P1, P2).
- ``interop``  -- numpy arrays of the JAX package's state -> port objects.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"

from nova_tpu_torch import constants, errors  # noqa: F401,E402
