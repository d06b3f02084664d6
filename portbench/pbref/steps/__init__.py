"""The reference's side of each step circuit, one file a circuit, found by
the circuit's name (``steps/<name>.py``). Each has ``z_out(z0, calls,
params, p)``, the IVC output after `calls` steps from z0, and
``rows_missing(A, B, C, params)``, by how many of the step circuit's own
constraints a primary shape (CSR matrices) differs from what the circuit
states, 0 when it has them all."""

import importlib.util
import os

DIR = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    path = os.path.join(DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no reference step circuit {name!r}")
    spec = importlib.util.spec_from_file_location(f"pbref_steps_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
