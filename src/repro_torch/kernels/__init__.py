"""Hand-written Hopper kernels, their plain PyTorch versions, and the
shared backend policy and launch counters (``runtime``)."""
