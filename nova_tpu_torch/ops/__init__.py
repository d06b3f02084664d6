"""Device vector state (FVec) and the fixed-base MSM on PyTorch tensors."""
