"""Plain PyTorch / NumPy references for the benchmark's correctness checks.

Nothing here imports jax, the JAX package or the program under test; each
module works from the benchmark's own inputs (the openai-layout state dict,
the JPEG bytes and caption strings)."""
