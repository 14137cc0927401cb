"""Device ops: attention dispatch, top-k, int8 search ops, k-means and PQ,
and the hand-written CUDA kernels."""
