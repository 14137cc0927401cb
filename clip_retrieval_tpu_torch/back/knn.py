"""KnnService: query encoding on the device + index search + post-filtering.

Counterpart of `clip_retrieval_tpu/back/knn.py`, with the same query
semantics (text / base64 image / image url / raw embedding, aesthetic
steering), the same dynamic-nprobe rule (ceil(k/3000) for ≥100k result ids),
the same post filters (connected-components dedup via range_search@0.94,
violence prompt argmax, NSFW threshold 0.5) and the same response shape
({id, similarity, **metadata}).

Queries are encoded in f32, as the JAX server does, by the port's
`encode_text` / `encode_image` on the model's device, micro-batched into
power-of-two buckets.
"""

from __future__ import annotations

import base64
import math
import os
import ssl
import threading
import urllib.request
from collections import defaultdict
from io import BytesIO
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..index.flat import FlatIndex
from ..models import clip as tclip
from ..models import safety as safety_mod
from ..utils.device import resolve_device
from . import metrics as M


def normalized(a: np.ndarray, axis: int = -1) -> np.ndarray:
    l2 = np.atleast_1d(np.linalg.norm(a, 2, axis))
    l2[l2 == 0] = 1
    return a / np.expand_dims(l2, axis)


@M.DOWNLOAD_TIME.time()
def download_image(url: str) -> BytesIO:
    req = urllib.request.Request(
        url,
        data=None,
        headers={"User-Agent": "Mozilla/5.0 (X11; Ubuntu; Linux x86_64; rv:72.0) Gecko/20100101 Firefox/72.0"},
    )
    ctx = ssl.create_default_context()
    ctx.set_alpn_protocols(["http/1.1"])
    with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
        return BytesIO(r.read())


def convert_metadata_to_base64(meta: Optional[dict]):
    if meta is not None and "image_path" in meta:
        path = meta["image_path"]
        if isinstance(path, bytes):
            path = path.decode()
        if isinstance(path, str) and os.path.exists(path):
            from PIL import Image

            img = Image.open(path)
            buffered = BytesIO()
            img.convert("RGB").save(buffered, format="JPEG")
            meta["image"] = base64.b64encode(buffered.getvalue()).decode("utf-8")


def meta_to_dict(meta: dict) -> dict:
    output = {}
    for k, v in meta.items():
        if isinstance(v, bytes):
            v = v.decode()
        elif type(v).__module__ == np.__name__:
            v = v.item()
        output[k] = v
    return output


def _bucket(n: int) -> int:
    """Power-of-two padding bucket the micro-batchers dispatch."""
    b = 1
    while b < n:
        b *= 2
    return b


class _Encoders:
    """f32 encode functions for one model bundle, with server-side
    micro-batching: concurrent requests share one device batch, padded to a
    power-of-two bucket."""

    def __init__(self, bundle, max_batch: int = 64, max_wait_ms: float = 3.0):
        from .batching import MicroBatcher

        self.bundle = bundle
        model = bundle.model.eval()
        self.device = next(model.parameters()).device

        def encode_text(tokens: np.ndarray) -> torch.Tensor:
            with torch.inference_mode():
                return tclip.encode_text(model, torch.from_numpy(tokens).to(self.device))

        def encode_image(images: np.ndarray) -> torch.Tensor:
            with torch.inference_mode():
                return tclip.encode_image(model, torch.from_numpy(images).to(self.device))

        self._encode_text = encode_text
        self._encode_image = encode_image

        # dispatch/finish split (MicroBatcher pipelining): dispatch stops once
        # the kernels are queued on the device, finish does the read-back
        def dispatch_text_batch(texts):
            tokens = self.bundle.tokenize(list(texts))
            n = tokens.shape[0]
            pad = _bucket(n) - n
            if pad:
                tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), tokens.dtype)])
            return encode_text(tokens)

        def dispatch_image_batch(arrays):
            batch = np.stack(arrays)
            n = batch.shape[0]
            pad = _bucket(n) - n
            if pad:
                batch = np.concatenate([batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
            return encode_image(batch)

        def finish_batch(feats_dev, n):
            feats = feats_dev.cpu().numpy().astype(np.float32)[:n]
            return [feats[i : i + 1] for i in range(n)]

        self._text_batcher = MicroBatcher(
            dispatch_text_batch, max_batch, max_wait_ms, name="text-encode", fn_finish=finish_batch
        )
        self._image_batcher = MicroBatcher(
            dispatch_image_batch, max_batch, max_wait_ms, name="image-encode", fn_finish=finish_batch
        )

    def warm(self, buckets=(1, 64)) -> None:
        """Run the encoders once at each micro-batch bucket the batchers
        dispatch (`_bucket(min(b, max_batch))`) before traffic: first calls
        pay the kernel build and the allocator's growth."""
        cfg = self.bundle.cfg
        max_b = self._text_batcher.max_batch
        for b in sorted({_bucket(min(b, max_b)) for b in buckets}):
            self._encode_text(np.zeros((b, cfg.context_length), np.int32)).cpu()
            self._encode_image(np.zeros((b, cfg.image_size, cfg.image_size, 3), np.uint8)).cpu()

    def text(self, text: str) -> np.ndarray:
        with M.TEXT_CLIP_INFERENCE_TIME.time():
            return self._text_batcher.submit(text)

    def image(self, img_data: BytesIO) -> np.ndarray:
        with M.IMAGE_PREPRO_TIME.time():
            arr = self.bundle.preprocess(img_data.read())
        with M.IMAGE_CLIP_INFERENCE_TIME.time():
            return self._image_batcher.submit(arr)


class KnnService:
    """The callable core behind the /knn-service endpoint.  `device` runs the
    violence-prompt scoring; encoders and indices run where their resource
    put them."""

    def __init__(self, clip_resources: Dict[str, Any], device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.clip_resources = clip_resources
        self._encoders: dict[str, _Encoders] = {}
        self._search_batchers: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._enc_build_locks: dict[str, threading.Lock] = {}
        self._nprobe_locks: dict[int, threading.Lock] = {}  # per index

    # bound on distinct (index, k) micro-batchers: k is client-controlled
    # (num_result_ids), and each batcher is a permanent daemon thread
    MAX_SEARCH_BATCHERS = 32

    def _search_batched(self, index, query: np.ndarray, k: int):
        """Micro-batched index.search_and_reconstruct: concurrent requests
        against the same (index, k) share one device search batch."""
        from .batching import MicroBatcher

        key = (id(index), k)
        with self._lock:
            batcher = self._search_batchers.get(key)
            if batcher is None and len(self._search_batchers) < self.MAX_SEARCH_BATCHERS:

                def run_batch(queries, _index=index, _k=k):
                    batch = np.concatenate(queries, axis=0)
                    with torch.inference_mode():
                        d, i, e = _index.search_and_reconstruct(batch, _k)
                    return [(d[j : j + 1], i[j : j + 1], e[j : j + 1]) for j in range(batch.shape[0])]

                batcher = MicroBatcher(run_batch, max_batch=32, max_wait_ms=3.0, name=f"search-k{k}")
                self._search_batchers[key] = batcher
        if batcher is None:  # cap reached: serve unbatched, never crash
            return index.search_and_reconstruct(query, k)
        return batcher.submit(query)

    def serving_stats(self) -> dict:
        """Micro-batcher counters (device batches executed / items served,
        batch-size histogram) per encoder and search batcher."""
        out: dict = {"encoders": {}, "search": {}}
        with self._lock:
            encoders = dict(self._encoders)
            searchers = dict(self._search_batchers)

        def row(b):
            return {"batches": b.n_batches, "items": b.n_items, "batch_sizes": dict(b.batch_sizes)}

        for name, enc in encoders.items():
            out["encoders"][name] = {"text": row(enc._text_batcher), "image": row(enc._image_batcher)}
        for (iid, k), b in searchers.items():
            out["search"][f"{iid}-k{k}"] = row(b)
        return out

    def stage_times(self, body: dict | None = None) -> dict:
        """Time the per-request device stages — text encode, optionally image
        encode, and index search — inside the server process, each call
        ending in its read-back, p50 over `iters`."""
        import time

        body = body or {}
        name = body.get("indice_name") or next(iter(self.clip_resources))
        if name not in self.clip_resources:
            raise ValueError(f"unknown indice_name: {name!r}")
        # clamp client-controlled knobs: this endpoint is on the same
        # unauthenticated CORS-* app as /knn-service
        iters = min(64, max(1, int(body.get("iters", 15))))
        k = min(1024, max(1, int(body.get("k", 40))))
        text_bucket = min(64, max(1, int(body.get("text_bucket", 16))))
        search_bucket = min(64, max(1, int(body.get("search_bucket", 16))))
        # image encode is the most expensive stage, probed only on request
        image_bucket = min(64, max(0, int(body.get("image_bucket", 0))))
        enc = self._enc(name)
        cfg = enc.bundle.cfg

        def p50(fn, warm=1):
            for _ in range(warm):
                fn()
            samples = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                samples.append(time.perf_counter() - t0)
            samples.sort()
            return round(samples[len(samples) // 2] * 1e3, 3)

        tokens = np.zeros((_bucket(text_bucket), cfg.context_length), np.int32)
        text_ms = p50(lambda: enc._encode_text(tokens).cpu())

        image_row = None
        if image_bucket:
            images = np.zeros((_bucket(image_bucket), cfg.image_size, cfg.image_size, 3), np.uint8)
            image_row = {"bucket": int(images.shape[0]), "p50_ms": p50(lambda: enc._encode_image(images).cpu())}

        res = self.clip_resources[name]
        index = res.image_index if res.image_index is not None else res.text_index
        if index is None:
            raise ValueError(f"no index loaded for {name!r}")
        rng = np.random.default_rng(0)
        q = rng.normal(size=(search_bucket, index.d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        with torch.inference_mode():
            search_ms = p50(lambda: index.search_and_reconstruct(q, k))

        out = {
            "indice_name": name,
            "iters": iters,
            "text_encode": {"bucket": int(tokens.shape[0]), "p50_ms": text_ms},
            "search": {"batch": search_bucket, "k": k, "p50_ms": search_ms},
        }
        if image_row is not None:
            out["image_encode"] = image_row
        return out

    def _enc(self, indice_name: str) -> _Encoders:
        # locked check-then-insert, the build under a per-index lock so a
        # cold encoder can't stall searches on other indices
        enc = self._encoders.get(indice_name)
        if enc is not None:
            return enc
        with self._lock:
            build_lock = self._enc_build_locks.setdefault(indice_name, threading.Lock())
        with build_lock:
            enc = self._encoders.get(indice_name)
            if enc is None:
                enc = _Encoders(self.clip_resources[indice_name].bundle)
                self._encoders[indice_name] = enc
        return enc

    # -- query embedding ---------------------------------------------------

    def compute_query(
        self,
        clip_resource,
        indice_name: str,
        text_input,
        image_input,
        image_url_input,
        embedding_input,
        use_mclip: bool,
        aesthetic_score,
        aesthetic_weight,
    ) -> np.ndarray:
        if text_input is not None and text_input != "":
            if use_mclip and clip_resource.model_txt_mclip is not None:
                with M.TEXT_CLIP_INFERENCE_TIME.time():
                    query = normalized(clip_resource.model_txt_mclip(text_input).astype(np.float32))
            else:
                query = self._enc(indice_name).text(text_input)
        elif image_input is not None or image_url_input is not None:
            if image_input is not None:
                img_data = BytesIO(base64.b64decode(image_input))
            else:
                img_data = download_image(image_url_input)
            query = self._enc(indice_name).image(img_data)
        elif embedding_input is not None:
            query = np.expand_dims(np.array(embedding_input).astype("float32"), 0)
        else:
            raise ValueError("empty query")

        if (
            clip_resource.aesthetic_embeddings is not None
            and aesthetic_score is not None
            and aesthetic_weight is not None
            and aesthetic_score in clip_resource.aesthetic_embeddings
        ):
            emb = clip_resource.aesthetic_embeddings[aesthetic_score]
            query = query + emb * aesthetic_weight
            query = query / np.linalg.norm(query)
        return query

    # -- post filters ------------------------------------------------------

    @staticmethod
    def hash_based_dedup(embeddings: np.ndarray) -> list[int]:
        """Cheap dedup on rounded-embedding hashes (reference
        clip_back.py:257-268); connected-components dedup below is the one
        used by the query flow."""
        seen: set = set()
        to_remove = []
        for i, embedding in enumerate(embeddings):
            h = hash(np.round(embedding, 2).tobytes())
            if h in seen:
                to_remove.append(i)
            else:
                seen.add(h)
        return to_remove

    @staticmethod
    def connected_components(neighbors: dict) -> list[list]:
        seen: set = set()
        groups = []
        for start in neighbors:
            if start in seen:
                continue
            comp, stack = [], {start}
            while stack:
                node = stack.pop()
                seen.add(node)
                stack |= set(neighbors[node]) - seen
                comp.append(node)
            groups.append(comp)
        return groups

    def get_non_uniques(self, embeddings: np.ndarray, threshold: float = 0.94) -> list[int]:
        index = FlatIndex(embeddings.shape[1], device="cpu")  # range_search runs on the host
        index.add(embeddings.astype(np.float16))
        lims, _, ids = index.range_search(embeddings, threshold)
        same = defaultdict(list)
        for i in range(embeddings.shape[0]):
            for j in ids[lims[i] : lims[i + 1]]:
                same[int(i)].append(int(j))
        non_uniques: set[int] = set()
        for group in self.connected_components(same):
            non_uniques.update(group[1:])
        return list(non_uniques)

    def get_unsafe_items(self, safety_model, embeddings: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        scores = safety_model.predict(embeddings, batch_size=embeddings.shape[0])
        x = np.array([e[0] for e in scores])
        return np.where(x > threshold)[0]

    def get_violent_items(self, safety_prompts: np.ndarray, embeddings: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            results = safety_mod.violence_scores(
                torch.as_tensor(np.asarray(embeddings, np.float32), device=self.device),
                torch.as_tensor(np.asarray(safety_prompts, np.float32), device=self.device),
            ).cpu().numpy()
        return np.where(results == 1)[0]

    def post_filter(
        self,
        safety_model,
        embeddings: np.ndarray,
        deduplicate: bool,
        use_safety_model: bool,
        use_violence_detector: bool,
        violence_detector,
    ) -> set:
        to_remove: set = set()
        if deduplicate:
            with M.DEDUP_TIME.time():
                to_remove = set(self.get_non_uniques(embeddings))
        if use_violence_detector and violence_detector is not None:
            to_remove |= set(int(i) for i in self.get_violent_items(violence_detector, embeddings))
        if use_safety_model and safety_model is not None:
            with M.SAFETY_TIME.time():
                to_remove |= set(int(i) for i in self.get_unsafe_items(safety_model, embeddings))
        return to_remove

    # -- search ------------------------------------------------------------

    def knn_search(
        self,
        query: np.ndarray,
        modality: str,
        num_result_ids: int,
        clip_resource,
        deduplicate: bool,
        use_safety_model: bool,
        use_violence_detector: bool,
    ):
        index = clip_resource.image_index if modality == "image" else clip_resource.text_index
        if index is None:
            raise ValueError(f"no index for modality {modality!r}")

        with M.KNN_INDEX_TIME.time():
            previous_nprobe = getattr(index, "nprobe", None)
            poke_nprobe = (
                clip_resource.metadata_is_ordered_by_ivf and num_result_ids >= 100000 and previous_nprobe is not None
            )
            if poke_nprobe:
                # dynamic-nprobe requests mutate index state; serialize the
                # whole poke+search+restore PER INDEX and always restore
                with self._lock:
                    nlock = self._nprobe_locks.setdefault(id(index), threading.Lock())
                with nlock:
                    previous_nprobe = index.nprobe  # re-read under the lock
                    try:
                        index.nprobe = math.ceil(num_result_ids / 3000)
                        distances, indices, embeddings = index.search_and_reconstruct(query, num_result_ids)
                    finally:
                        index.nprobe = previous_nprobe
            else:
                distances, indices, embeddings = self._search_batched(
                    index, np.asarray(query, np.float32), num_result_ids
                )
            if clip_resource.metadata_is_ordered_by_ivf:
                # -1 padding must survive the remap as -1
                raw = indices[0]
                results = np.where(
                    raw >= 0, np.take(clip_resource.ivf_old_to_new_mapping, np.clip(raw, 0, None)), -1
                )
            else:
                results = indices[0]

        # truncate at the first -1 (same as reference)
        sentinels = np.where(results == -1)[0]
        nb = sentinels[0] if len(sentinels) > 0 else len(results)
        result_indices = results[:nb]
        result_distances = distances[0][:nb]
        result_embeddings = normalized(embeddings[0][:nb])

        local_remove = self.post_filter(
            clip_resource.safety_model,
            result_embeddings,
            deduplicate,
            use_safety_model,
            use_violence_detector,
            clip_resource.violence_detector,
        )
        indices_to_remove = {int(result_indices[i]) for i in local_remove}
        out_indices, out_distances = [], []
        for ind, dist in zip(result_indices, result_distances):
            if int(ind) not in indices_to_remove:
                indices_to_remove.add(int(ind))
                out_indices.append(ind)
                out_distances.append(dist)
        return out_distances, out_indices

    # -- metadata join -----------------------------------------------------

    def map_to_metadata(self, indices, distances, num_images, metadata_provider, columns_to_return) -> List[dict]:
        results = []
        with M.METADATA_GET_TIME.time():
            metas = metadata_provider.get(indices[:num_images], columns_to_return)
        for key, (dist, ind) in enumerate(zip(distances, indices)):
            output: dict = {}
            meta = None if key + 1 > len(metas) else metas[key]
            convert_metadata_to_base64(meta)
            if meta is not None:
                output.update(meta_to_dict(meta))
            output["id"] = int(ind)
            output["similarity"] = float(dist)
            results.append(output)
        return results

    # -- entry -------------------------------------------------------------

    def query(
        self,
        text_input=None,
        image_input=None,
        image_url_input=None,
        embedding_input=None,
        modality: str = "image",
        num_images: int = 100,
        num_result_ids: int = 100,
        indice_name: str | None = None,
        use_mclip: bool = False,
        deduplicate: bool = True,
        use_safety_model: bool = False,
        use_violence_detector: bool = False,
        aesthetic_score=None,
        aesthetic_weight=None,
    ) -> List[dict]:
        if text_input is None and image_input is None and image_url_input is None and embedding_input is None:
            raise ValueError("must fill one of text, image and image url input")
        if indice_name is None:
            indice_name = next(iter(self.clip_resources.keys()))
        clip_resource = self.clip_resources[indice_name]

        query = self.compute_query(
            clip_resource,
            indice_name,
            text_input,
            image_input,
            image_url_input,
            embedding_input,
            use_mclip,
            aesthetic_score,
            aesthetic_weight,
        )
        distances, indices = self.knn_search(
            query,
            modality=modality,
            num_result_ids=num_result_ids,
            clip_resource=clip_resource,
            deduplicate=deduplicate,
            use_safety_model=use_safety_model,
            use_violence_detector=use_violence_detector,
        )
        if len(distances) == 0:
            return []
        return self.map_to_metadata(
            indices, distances, num_images, clip_resource.metadata_provider, clip_resource.columns_to_return
        )

    @M.FULL_KNN_REQUEST_TIME.time()
    def handle_post(self, json_data: dict) -> List[dict]:
        """Parse a /knn-service request body (the reference's field contract)."""
        aesthetic_score = json_data.get("aesthetic_score", "")
        aesthetic_score = int(aesthetic_score) if aesthetic_score != "" else None
        aesthetic_weight = json_data.get("aesthetic_weight", "")
        aesthetic_weight = float(aesthetic_weight) if aesthetic_weight != "" else None
        num_images = json_data["num_images"]
        return self.query(
            text_input=json_data.get("text"),
            image_input=json_data.get("image"),
            image_url_input=json_data.get("image_url"),
            embedding_input=json_data.get("embedding_input"),
            modality=json_data.get("modality", "image"),
            num_images=num_images,
            num_result_ids=json_data.get("num_result_ids", num_images),
            indice_name=json_data.get("indice_name"),
            use_mclip=json_data.get("use_mclip", False),
            deduplicate=json_data.get("deduplicate", False),
            use_safety_model=json_data.get("use_safety_model", False),
            use_violence_detector=json_data.get("use_violence_detector", False),
            aesthetic_score=aesthetic_score,
            aesthetic_weight=aesthetic_weight,
        )


class MetadataService:
    """POST /metadata — metadata for explicit ids."""

    def __init__(self, clip_resources: Dict[str, Any]):
        self.clip_resources = clip_resources

    def handle_post(self, json_data: dict):
        ids = json_data["ids"]
        if len(ids) == 0:
            return []
        indice_name = json_data["indice_name"]
        resource = self.clip_resources[indice_name]
        metas = resource.metadata_provider.get(ids, resource.columns_to_return)
        for meta in metas:
            convert_metadata_to_base64(meta)
        return [{"id": item_id, "metadata": meta_to_dict(meta)} for item_id, meta in zip(ids, metas)]
