"""PyTorch/CUDA port of clip_retrieval_tpu: CLIP embedding inference and the
/knn-service query path on an NVIDIA GPU, with hand-written Hopper kernels
where the JAX package used Pallas kernels.  Imports torch, never jax."""
