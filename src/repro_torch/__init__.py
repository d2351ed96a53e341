"""PyTorch/CUDA port of the RBLA federated-learning system.

Runs beside the JAX package ``repro`` (the reference), with the same
subpackage and module names.  Entry points run on ``device="cuda"`` unless
the caller asks for the CPU; the aggregation kernels are CUDA C++ for
Hopper, built at first use (see ``repro_torch.kernels.build``).
"""
