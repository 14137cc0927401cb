"""PyTorch/CUDA port of clip_retrieval_tpu: CLIP embedding inference and the
/knn-service query path on an NVIDIA GPU, with hand-written Hopper kernels
where the JAX package used Pallas kernels.  Imports torch, never jax."""

import importlib

__version__ = "0.1.0"

# the reference package's top-level exports (`from clip_retrieval import
# clip_inference, clip_index, clip_back, ...`): name → (module, attribute)
_API = {
    "clip_inference": ("inference.main", "main"),
    "clip_index": ("index.build", "clip_index"),
    "clip_back": ("back.app", "clip_back"),
    "clip_filter": ("filter", "clip_filter"),
    "clip_end2end": ("end2end", "clip_end2end"),
    "ClipClient": ("client", "ClipClient"),
    "Modality": ("client", "Modality"),
}


def __getattr__(name):
    """Resolve the top-level API lazily, so importing the package loads
    neither torch nor any entry point's dependencies."""
    if name in _API:
        module, attr = _API[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
