"""The bench grids (twins of the repository's ``benches/``), each run as
``python -m nova_tpu_torch.benches.<name> [--sizes 14,16] [--quick]``; one
JSON line per configuration. They run on the card; a test passes
``device="cpu"`` to ``main`` for the plain PyTorch versions."""
