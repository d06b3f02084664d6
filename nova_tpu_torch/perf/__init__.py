"""Microbenchmarks of the port (``python -m nova_tpu_torch.perf.<name>``)."""
