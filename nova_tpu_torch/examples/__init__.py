"""The example IVC programs (twins of the repository's ``examples/``), each
run as ``python -m nova_tpu_torch.examples.<name> [arguments]`` on the
card; a test passes ``device="cpu"`` to ``main`` for the plain PyTorch
versions."""
