"""Device ops: attention dispatch, top-k and int8 search ops, and the
hand-written CUDA kernels."""
