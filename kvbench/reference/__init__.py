"""Plain float32 PyTorch references: no kernel, cache or batching, and
nothing of the program (``repro_torch``) or of the JAX package."""
