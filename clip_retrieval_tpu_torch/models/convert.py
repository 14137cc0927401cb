"""Checkpoint conversion: torch/HF CLIP checkpoints → npz, and the published
autokeras NSFW heads → `nsfw_mlp.npz`.

Counterpart of `clip_retrieval_tpu/models/convert.py`; the files it writes
load in both packages.

  clip-retrieval-tpu-torch convert --checkpoint /path/model.pt --output /out.npz \\
      --clip_model RN50 --device cuda
  clip-retrieval-tpu-torch convert.nsfw_keras --model_path clip_autokeras_binary_nsfw.zip \\
      --output nsfw_mlp.npz

The CLIP npz holds the original (state-dict-style) arrays; loading goes
through `loaders.load_checkpoint`, the same path as torch files.  The NSFW
conversion reads the SavedModel's variables with `tensorflow`, imported only
here, at conversion time.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve_device


def convert(checkpoint: str, output: str, clip_model: str | None = None, device: str | torch.device = "cuda"):
    """Convert a torch/HF CLIP checkpoint file to an npz state dict.

    With `clip_model`, the npz is validated by loading it into that config
    on `device`.  The default device is CUDA; without a GPU it raises before
    any work unless given "cpu"."""
    device = resolve_device(device)
    obj = torch.load(checkpoint, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict):
        sd = obj.get("state_dict", obj)
    else:
        raise ValueError(f"unrecognized checkpoint object {type(obj)}")
    arrays = {}
    for k, v in sd.items():
        try:
            arrays[k] = v.detach().cpu().numpy()
        except TypeError:  # torch bf16 has no numpy dtype
            arrays[k] = v.detach().cpu().float().numpy()
        except AttributeError:
            arrays[k] = np.asarray(v)
    if not output.endswith(".npz"):
        # np.savez appends .npz itself; the validation and the returned path name the file written
        output += ".npz"
    np.savez(output, **arrays)
    print(f"wrote {len(arrays)} arrays to {output}")
    if clip_model:
        from . import loaders
        from .configs import get_config

        model, _ = loaders.load_checkpoint(output, get_config(clip_model), device)
        n = sum(p.numel() for p in model.parameters())
        print(f"validated against {clip_model}: {n/1e6:.1f}M params")
    return output


def keras_nsfw_weights(model_dir: str):
    """The published autokeras NSFW classifier's weights → [(W, b)] of the
    plain MLP, read from the SavedModel's variables with the checkpoint
    reader (no autokeras needed); the Normalization layer is folded into the
    first dense layer.

    Returns (weights, final_activation): "sigmoid" for the binary L/14 head,
    "softmax" for the multi-class B/32 head."""
    import re

    import tensorflow as tf

    prefix = os.path.join(model_dir, "variables", "variables")
    groups: dict[int, dict[str, np.ndarray]] = {}
    reader = tf.train.load_checkpoint(prefix)
    for name, _ in tf.train.list_variables(prefix):
        m = re.match(r"layer_with_weights-(\d+)/(\w+)/", name)
        if m:
            groups.setdefault(int(m.group(1)), {})[m.group(2)] = reader.get_tensor(name)
    if not groups:
        raise ValueError(f"no layer variables found under {prefix}")
    norm = None
    weights = []
    for _, g in sorted(groups.items()):
        if "mean" in g and "variance" in g:
            norm = (np.asarray(g["mean"], np.float32), np.asarray(g["variance"], np.float32))
        elif "kernel" in g:
            bias = g.get("bias", np.zeros(g["kernel"].shape[1]))
            weights.append((np.asarray(g["kernel"], np.float32), np.asarray(bias, np.float32)))
    if not weights:
        raise ValueError(f"no dense layers found under {prefix}")
    if norm is not None:
        # fold (x - mean)/std into the first dense: x@(W/std) + (b - (mean/std)@W)
        mean, var = norm
        std = np.maximum(np.sqrt(var), 1e-7)
        w0, b0 = weights[0]
        weights[0] = (w0 / std[:, None], b0 - (mean / std) @ w0)
    final_act = "sigmoid" if weights[-1][0].shape[1] == 1 else "softmax"
    return weights, final_act


def convert_keras_nsfw(model_path: str, output: str) -> str:
    """Convert an autokeras NSFW SavedModel (directory or .zip) to an MLP npz."""
    import tempfile
    import zipfile

    from .safety import save_mlp_npz

    with tempfile.TemporaryDirectory() as tmp:
        if model_path.endswith(".zip"):
            with zipfile.ZipFile(model_path) as z:
                z.extractall(tmp)
            entries = [d for d in os.listdir(tmp) if os.path.isdir(os.path.join(tmp, d))]
            model_path = os.path.join(tmp, entries[0]) if entries else tmp
        weights, final_act = keras_nsfw_weights(model_path)
    save_mlp_npz(output, weights, final_activation=final_act, relu_last_n_skipped=1)
    print(f"wrote {len(weights)}-layer MLP (final={final_act}) to {output}")
    return output
