"""clip-filter: extract a subset of an image collection with a kNN query.

Counterpart of `clip_retrieval_tpu/filter.py` (reference
`clip_retrieval/clip_filter.py:7-74`): encode a text or image-file query with
the port's towers on `device` (f32, as `back` encodes; the text tower's
causal attention and the image tower's attention run kernel K1 on a card),
search the image index loaded on `device` (top-k through its own route,
kernel K3 or K4 for the IVF tiers, or a range search over a flat index when
`threshold` is given), copy the matched files to the output folder and print
their urls.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
import torch

from .utils.device import resolve_device


def clip_filter(
    query: str,
    output_folder: str,
    indice_folder: str,
    num_results: int = 100,
    threshold: float | None = None,
    clip_model: str = "ViT-B/32",
    checkpoint: str | None = None,
    device: str = "cuda",
):
    """Copy the images of an index that match a text or image-file query."""
    import pandas as pd

    from .index.store import load_index
    from .models import clip as tclip
    from .models import zoo

    device = resolve_device(device)
    bundle = zoo.load_model(clip_model, checkpoint, device)
    model = bundle.model.eval()

    data_dir = Path(indice_folder) / "metadata"
    df = pd.concat(pd.read_parquet(p) for p in sorted(data_dir.glob("*.parquet")))
    url_list = df["url"].tolist() if "url" in df else None
    image_list = df["image_path"].tolist()
    index = load_index(indice_folder + "/image.index", device=device)

    os.makedirs(output_folder, exist_ok=True)

    with torch.inference_mode():
        if query.endswith((".png", ".jpg", ".jpeg", ".bmp")) and os.path.isfile(query):
            arr = bundle.preprocess(Path(query).read_bytes())
            # a decoded PIL image is a read-only view: copy it into the batch
            feats = tclip.encode_image(model, torch.from_numpy(np.stack([arr])).to(device))
        else:
            tokens = bundle.tokenize([query])
            feats = tclip.encode_text(model, torch.from_numpy(tokens).to(device))
    q = feats.cpu().numpy().astype(np.float32)

    if threshold is not None:
        if not hasattr(index, "range_search"):
            raise ValueError("threshold filtering requires a flat index (range_search)")
        _, d, i = index.range_search(q, threshold)
        print(f"Found {i.shape} items with query '{query}' and threshold {threshold}")
    else:
        d, i = index.search(q, num_results)
        d, i = d[0], i[0]
        keep = i >= 0
        d, i = d[keep], i[keep]
        print(f"Found {num_results} items with query '{query}'")

    if len(d):
        print(f"The minimum distance is {min(d):.2f} and the maximum is {max(d):.2f}")
        print("You may want to use these numbers to increase your --num_results parameter. Or use the --threshold "
              "parameter.")

    print(f"Copying the images in {output_folder}")
    for ei in i:
        path = image_list[int(ei)]
        if os.path.exists(path):
            shutil.copy(path, output_folder)
        if url_list is not None:
            print(url_list[int(ei)])
