"""clip-end2end: corpus → embeddings → index → serving in one command.

Counterpart of `clip_retrieval_tpu/end2end.py` (reference
`clip_retrieval/clip_end2end.py:6-55`): the port's `clip_inference`,
`clip_index` and `clip_back`, each on `device`.  img2dataset is an optional
import, reached only when `input_dataset` is None (a download from
`url_list`); without a network, pass an existing folder or webdataset as
`input_dataset`/`input_format`.
"""

from __future__ import annotations

import json
import os

from .utils.device import resolve_device


def clip_end2end(
    url_list: str | None = None,
    output_folder: str = "e2e_output",
    run_back: bool = True,
    input_dataset=None,
    input_format: str = "webdataset",
    clip_model: str = "ViT-B/32",
    checkpoint: str | None = None,
    port: int = 1234,
    batch_size: int = 256,
    enable_metadata: bool = True,
    device: str = "cuda",
):
    """Embed a corpus, index the embeddings and (run_back) serve them."""
    import fsspec

    from .back.app import clip_back
    from .index.build import clip_index
    from .inference.main import clip_inference

    resolve_device(device)  # fail before any work when the GPU is missing
    if "://" in output_folder:
        # the index-build and serving stages work on local paths;
        # os.path.join on a URL would silently create a literal ./s3:/...
        # tree (the reference's clip_end2end has the same constraint)
        raise ValueError(
            "end2end requires a local output_folder; for remote storage "
            "run the stages individually (inference supports fsspec "
            "output, then copy/build the index where it will be served)"
        )
    fs, out = fsspec.core.url_to_fs(output_folder)
    fs.makedirs(out, exist_ok=True)
    embeddings_folder = os.path.join(output_folder, "embeddings")
    index_folder = os.path.join(output_folder, "index")

    if input_dataset is None:
        if url_list is None:
            raise ValueError("pass url_list (img2dataset) or input_dataset")
        image_folder = os.path.join(output_folder, "images")
        from img2dataset import download  # optional dependency

        download(
            url_list,
            image_size=256,
            output_folder=image_folder,
            thread_count=128,
            processes_count=4,
            input_format="parquet",
            output_format="webdataset",
            url_col="URL",
            caption_col="TEXT",
        )
        input_dataset = [os.path.join(image_folder, p) for p in next(fs.walk(image_folder))[2] if p.endswith(".tar")]
        input_format = "webdataset"

    clip_inference(
        input_dataset=input_dataset,
        output_folder=embeddings_folder,
        input_format=input_format,
        enable_metadata=enable_metadata,
        write_batch_size=100000,
        batch_size=batch_size,
        clip_model=clip_model,
        checkpoint=checkpoint,
        device=device,
    )
    os.makedirs(index_folder, exist_ok=True)
    clip_index(embeddings_folder, index_folder=index_folder, device=device)

    indice_path = os.path.join(output_folder, "indices_paths.json")
    with fsspec.open(indice_path, "w") as f:
        f.write(json.dumps({"example_index": index_folder}))
    if run_back:
        clip_back(port=port, indices_paths=indice_path, clip_model=clip_model, checkpoint=checkpoint, device=device)
