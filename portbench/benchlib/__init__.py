"""The benchmark harness of the PyTorch/CUDA prover: cells found by name in
BENCHMARK.json, configurations and traffic mixes read from data files, one
driver per kind of traffic, per-layer metrics read by small readers of their
own, and the comparison with the plain reference (``pbref``)."""
