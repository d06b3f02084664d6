"""In-circuit verifier gadgets (reference: src/gadgets/ + the vendored
neptune circuit): EC point arithmetic, non-native BigNat arithmetic,
Poseidon sponge circuit, field-switch utilities."""
