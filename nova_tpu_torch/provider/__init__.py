"""Provider layer: Keccak/Shake256, hash-to-curve and the Pedersen
commitment engine."""
