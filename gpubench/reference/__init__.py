"""Plain PyTorch references of what each cell's timed path computes.

They import ``torch``, ``numpy`` and the standard library only: nothing of
the program under test (``repro_torch``), of the JAX package (``repro``)
or of ``jax``.  They take the inputs the benchmark made and work out again
everything the program derives from them."""
