"""Plain reference for the benchmark's correctness checks.

Python integers and NumPy only. Nothing here imports the program under test
or its JAX original: the generators of a Pedersen key are derived again from
their label (``h2c``), a multi-scalar multiplication is a plain Pippenger
(``msm``), and a relaxed R1CS is checked row by row (``r1cs``)."""
