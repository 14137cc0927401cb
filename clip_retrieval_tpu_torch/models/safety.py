"""Safety / violence / aesthetic heads on torch tensors.

Counterpart of `clip_retrieval_tpu/models/safety.py`: an NSFW MLP, prompt-
embedding violence detection, and aesthetic rating embeddings added to the
query.  The MLP is a plain list of (W, b) tensors on one device, run under
`torch.inference_mode`.

Weights load from the same places as the JAX package: `nsfw_mlp.npz` in
`~/.cache/clip_retrieval_tpu/<model>/` (the file `save_mlp_npz` of either
package writes), the reference's torch H14 checkpoint, the published
autokeras NSFW SavedModel directories in either cache layout (converted once
by `models/convert.py`, which needs `tensorflow`, and cached as
`nsfw_mlp.npz`), violence prompt embeddings and aesthetic rating embeddings
in either cache layout.  With CRT_ALLOW_DOWNLOAD=1 what is not found locally
is fetched from the reference's URLs into the JAX package's paths.  Missing
weights → None (the serving option degrades off with a warning).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

H14_LAYER_DIMS = [1024, 2048, 1024, 256, 128, 16, 1]  # after the input dim


def cache_folder(clip_model: str) -> str:
    home = os.path.expanduser("~")
    folder = os.path.join(home, ".cache", "clip_retrieval_tpu", clip_model.replace("/", "_"))
    os.makedirs(folder, exist_ok=True)
    return folder


class MLP:
    """ReLU MLP covering both reference NSFW heads: the torch H14 detector
    (ReLU after all but the last two layers, raw output) and the converted
    autokeras classifiers (ReLU between layers, sigmoid/softmax output)."""

    def __init__(self, weights: List[Tuple[np.ndarray, np.ndarray]], relu_last_n_skipped: int = 2,
                 final_activation: str | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.weights = [
            (torch.as_tensor(np.asarray(w, np.float32), device=self.device),
             torch.as_tensor(np.asarray(b, np.float32), device=self.device))
            for w, b in weights
        ]
        self.skip = relu_last_n_skipped
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.weights)
        for i, (w, b) in enumerate(self.weights):
            x = torch.matmul(x, w) + b
            if i < n - self.skip:
                x = torch.relu(x)
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.final_activation == "softmax":
            x = torch.softmax(x, dim=-1)
        return x

    def predict(self, embeddings: np.ndarray, batch_size: int | None = None) -> np.ndarray:
        """autokeras-compatible interface (returns (n, 1) scores)."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(embeddings, np.float32), device=self.device)
            return self.forward(x).cpu().numpy()

    @classmethod
    def random(cls, input_dim: int, seed: int = 0, device: str | torch.device = "cuda") -> "MLP":
        """Random-weight instance (tests only), the JAX package's draws."""
        rng = np.random.default_rng(seed)
        dims = [input_dim] + H14_LAYER_DIMS
        weights = [
            (rng.normal(size=(a, b)).astype(np.float32) / np.sqrt(a), np.zeros((b,), np.float32))
            for a, b in zip(dims[:-1], dims[1:])
        ]
        return cls(weights, device=device)


def _torch_mlp_to_weights(state_dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """torch nn.Sequential state dict (layers.N.weight/bias) → [(W, b)]."""
    idxs = sorted({int(k.split(".")[1]) for k in state_dict if k.startswith("layers.") and k.endswith(".weight")})
    out = []
    for i in idxs:
        w = np.asarray(state_dict[f"layers.{i}.weight"])
        b = np.asarray(state_dict[f"layers.{i}.bias"])
        out.append((w.T, b))  # torch stores (out, in)
    return out


def _reference_cache(clip_model: str) -> str:
    return os.path.expanduser("~/.cache/clip_retrieval/" + clip_model.replace("/", "_"))


# the published autokeras NSFW heads (reference clip_back.py:745-752): URL, and the directory the zip holds
_NSFW_ZIP_URLS = {
    "ViT-L/14": ("https://raw.githubusercontent.com/LAION-AI/CLIP-based-NSFW-Detector/main/"
                 "clip_autokeras_binary_nsfw.zip", "clip_autokeras_binary_nsfw"),
    "ViT-B/32": ("https://raw.githubusercontent.com/LAION-AI/CLIP-based-NSFW-Detector/main/"
                 "clip_autokeras_nsfw_b32.zip", "clip_autokeras_nsfw_b32"),
}
_H14_URL = "https://github.com/LAION-AI/CLIP-based-NSFW-Detector/raw/main/h14_nsfw.pth"


def _downloads_allowed() -> bool:
    return os.environ.get("CRT_ALLOW_DOWNLOAD") == "1"


def _maybe_download(url: str, dest: str) -> bool:
    """Fetch url → dest when CRT_ALLOW_DOWNLOAD=1; False otherwise or on error."""
    if not _downloads_allowed():
        return False
    from urllib.request import urlretrieve

    try:
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        urlretrieve(url, dest)
    except Exception as e:  # no network, HTTP error, disk full: serve without the artifact, as JAX does
        print(f"download of {url} failed: {e}")
        return False
    return True


def _keras_nsfw_dir(clip_model: str) -> Optional[str]:
    """The published autokeras SavedModel directory for this clip model in
    our cache or the reference's, or, with CRT_ALLOW_DOWNLOAD=1, fetched and
    unzipped into our cache; None when there is none."""
    if clip_model not in _NSFW_ZIP_URLS:
        return None
    url, dirname = _NSFW_ZIP_URLS[clip_model]
    for root in (cache_folder(clip_model), _reference_cache(clip_model)):
        d = os.path.join(root, dirname)
        if os.path.isdir(d):
            return d
    zip_path = os.path.join(cache_folder(clip_model), dirname + ".zip")
    if _maybe_download(url, zip_path):
        import zipfile

        with zipfile.ZipFile(zip_path) as z:
            z.extractall(cache_folder(clip_model))
        d = os.path.join(cache_folder(clip_model), dirname)
        if os.path.isdir(d):
            return d
    return None


def load_safety_model(clip_model: str, device: str | torch.device = "cuda") -> Optional[MLP]:
    """Load an NSFW scorer for this model's embedding space, or None.

    Sources, in order: converted npz in our cache; the reference's torch
    H14 checkpoint (open_clip:ViT-H-14 only, the only space it fits); the
    published autokeras SavedModel in either cache layout, converted on the
    fly and cached as npz.  With CRT_ALLOW_DOWNLOAD=1 the published zips and
    the H14 checkpoint are fetched as the reference fetches them."""
    device = resolve_device(device)
    npz_path = os.path.join(cache_folder(clip_model), "nsfw_mlp.npz")
    if os.path.exists(npz_path):
        return load_mlp_npz(npz_path, device)
    h14_path = os.path.expanduser("~/.cache/clip_retrieval/h14_nsfw_model/model.pt")
    if clip_model == "open_clip:ViT-H-14" and os.path.exists(h14_path):
        try:
            sd = torch.load(h14_path, map_location="cpu", weights_only=False)
            return MLP(_torch_mlp_to_weights(sd), device=device)
        except Exception as e:  # not a state dict of the MLP: look further, as JAX does
            print(f"failed to load NSFW model from {h14_path}: {e}")
    keras_dir = _keras_nsfw_dir(clip_model)
    if keras_dir is not None:
        from .convert import keras_nsfw_weights

        try:
            weights, final_act = keras_nsfw_weights(keras_dir)
        except Exception as e:  # no tensorflow, or not a SavedModel: serve without the head, as JAX does
            print(f"failed to convert keras NSFW model {keras_dir}: {e}")
        else:
            save_mlp_npz(npz_path, weights, final_activation=final_act, relu_last_n_skipped=1)
            return MLP(weights, relu_last_n_skipped=1, final_activation=final_act, device=device)
    if clip_model == "open_clip:ViT-H-14" and not os.path.exists(h14_path) and _maybe_download(_H14_URL, h14_path):
        # load the fetched file here: a second call would fetch again and, on an unloadable artifact (an error
        # page), again after that.  Only tensors are unpickled from a file off the network.
        try:
            sd = torch.load(h14_path, map_location="cpu", weights_only=True)
            return MLP(_torch_mlp_to_weights(sd), device=device)
        except Exception as e:
            print(f"downloaded H14 NSFW checkpoint failed to load: {e}")
    print(f"WARNING: no NSFW model weights found for {clip_model}; use_safety_model requests will be ignored")
    return None


def save_mlp_npz(path: str, weights: List[Tuple[np.ndarray, np.ndarray]], final_activation: str | None = None,
                 relu_last_n_skipped: int = 2):
    arrays = {}
    for i, (w, b) in enumerate(weights):
        arrays[f"w{i}"] = np.asarray(w)
        arrays[f"b{i}"] = np.asarray(b)
    arrays["final_activation"] = np.asarray(final_activation or "")
    arrays["relu_last_n_skipped"] = np.asarray(relu_last_n_skipped)
    np.savez(path, **arrays)


def load_mlp_npz(path: str, device: str | torch.device = "cuda") -> MLP:
    device = resolve_device(device)
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("w")])
        weights = [(z[f"w{i}"], z[f"b{i}"]) for i in range(n)]
        final_act = str(z["final_activation"]) if "final_activation" in z.files else ""
        skip = int(z["relu_last_n_skipped"]) if "relu_last_n_skipped" in z.files else 2
    return MLP(weights, relu_last_n_skipped=skip, final_activation=final_act or None, device=device)


def load_violence_detector(clip_model: str) -> Optional[np.ndarray]:
    """(n_prompts, d) prompt embeddings; column 1 = violent class.  From
    either cache layout or, with CRT_ALLOW_DOWNLOAD=1, the reference's URL."""
    name = "violence_detection_" + clip_model.replace("/", "_").replace("-", "_").lower() + ".npy"
    for folder in (cache_folder(clip_model), _reference_cache(clip_model)):
        path = os.path.join(folder, name)
        if os.path.exists(path):
            return np.load(path)
    dest = os.path.join(cache_folder(clip_model), name)
    if _maybe_download("https://github.com/LAION-AI/CLIP-based-NSFW-Detector/raw/main/" + name, dest):
        return np.load(dest)
    print(f"WARNING: no violence-detector prompts for {clip_model}; use_violence_detector requests will be ignored")
    return None


def get_aesthetic_embedding(clip_model: str) -> Optional[dict[int, np.ndarray]]:
    """rating k → (1, d) embedding, from our cache or the reference's layout,
    or, with CRT_ALLOW_DOWNLOAD=1, the LAION aesthetic-predictor's rating
    embeddings (ViT-B/32 and ViT-L/14) fetched into our cache."""
    folders = [os.path.join(root, "aesthetic") for root in (cache_folder(clip_model), _reference_cache(clip_model))]
    for folder in folders:
        paths = [os.path.join(folder, f"rating{k}.npy") for k in range(10)]
        if all(os.path.exists(p) for p in paths):
            return {k: np.load(p) for k, p in enumerate(paths)}
    tag = {"ViT-B/32": "vit_b_32", "ViT-L/14": "vit_l_14"}.get(clip_model)
    if tag and _downloads_allowed():
        paths = [os.path.join(folders[0], f"rating{k}.npy") for k in range(10)]
        url = f"https://github.com/LAION-AI/aesthetic-predictor/blob/main/{tag}_embeddings/rating{{}}.npy?raw=true"
        if all(_maybe_download(url.format(k), p) for k, p in enumerate(paths)):
            return {k: np.load(p) for k, p in enumerate(paths)}
    print(f"WARNING: no aesthetic embeddings cached for {clip_model}; aesthetic steering disabled")
    return None


def violence_scores(embeddings: torch.Tensor, prompts: torch.Tensor) -> torch.Tensor:
    """argmax over prompt classes; class 1 = violent."""
    return torch.argmax(torch.matmul(embeddings.float(), prompts.float().T), dim=1)
