"""The port's /knn-service app against the JAX package's, on the CPU.

The fixture is tests/test_back/test_serving.py's serving stack (400 seeded
unit vectors with a planted duplicate trio, parquet metadata, a Flat index
built by the JAX `clip_index`), served by both packages from the same
checkpoint (the tiny HF CLIPModel of tests/test_torch_pipeline.py) and the
same violence-prompt file in a local cache.  The same requests go to both
apps: ids must be identical and similarities within 1e-4 (the text and image
queries are encoded by two implementations of one model).  Both packages'
`/metrics` are read in this one process: each renders its own registry.

The port's `ClipClient` runs against the port's app over a real socket and
must get the JAX client's and a raw POST's answers.  An IVF16,PQ16 index
built by the JAX `clip_index` is prepared for IVF-reordered metadata by each
package (`ivf_old_to_new_mapping.npy`, `metadata_reordered.hdf5`, byte-equal
between them) and served by both packages from either preparation, with the
same ids and metadata per result.
"""

import base64
import io
import json
import re

import numpy as np
import pandas as pd
import pytest

from clip_retrieval_tpu.back.app import make_app as jax_make_app
from clip_retrieval_tpu.back.options import ClipOptions as JaxClipOptions
from clip_retrieval_tpu.back.resources import load_clip_indices as jax_load
from clip_retrieval_tpu.index.build import clip_index
from clip_retrieval_tpu_torch.back.app import make_app as torch_make_app
from clip_retrieval_tpu_torch.back.options import ClipOptions as TorchClipOptions
from clip_retrieval_tpu_torch.back.resources import load_clip_indices as torch_load
from clip_retrieval_tpu_torch.models import safety as t_safety

from tests.test_back.wsgi_client import request
from tests.test_torch_pipeline import checkpoint  # noqa: F401  (module fixture)

D = 32  # test-tiny embed dim
SIM_ATOL = 1e-4
COLUMNS = ["url", "image_path", "caption", "NSFW"]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _jpeg_b64(color):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (40, 40), color).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def served(tmp_path_factory, checkpoint):  # noqa: F811
    ckpt, bpe = checkpoint
    root = tmp_path_factory.mktemp("serving")
    emb = root / "emb"
    for sub in ("img_emb", "text_emb", "metadata"):
        (emb / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = 400
    x = _unit(rng.normal(size=(n, D)))
    x[11] = x[10]  # a duplicate trio for dedup
    x[12] = x[10]
    np.save(emb / "img_emb" / "img_emb_0.npy", x.astype(np.float16))
    np.save(emb / "text_emb" / "text_emb_0.npy", x.astype(np.float16))
    from PIL import Image

    img_path = str(root / "img_0.jpg")
    Image.new("RGB", (16, 16), (200, 30, 30)).save(img_path)
    pd.DataFrame({
        "image_path": [img_path if i == 0 else f"/nonexistent/{i}.jpg" for i in range(n)],
        "caption": [f"caption {i}" for i in range(n)],
        "url": [f"http://example.com/{i}.jpg" for i in range(n)],
        "NSFW": ["UNLIKELY"] * n,
    }).to_parquet(emb / "metadata" / "metadata_0.parquet")
    index_folder = root / "index"
    clip_index(str(emb), str(index_folder), index_key="Flat", compute_recall=False)
    paths = root / "indices_paths.json"
    paths.write_text(json.dumps({"test_index": str(index_folder)}))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRT_BPE_PATH", bpe)
        mp.setenv("HOME", str(root / "home"))
        # violence prompts in the shared local cache: class 1 = x[3]'s direction
        prompts = np.stack([-x[3], x[3]])
        np.save(f"{t_safety.cache_folder('test-tiny')}/violence_detection_test_tiny.npy", prompts)
        common = dict(clip_model="test-tiny", checkpoint=ckpt, columns_to_return=COLUMNS,
                      provide_aesthetic_embeddings=False, provide_violence_detector=True)
        jres = jax_load(str(paths), JaxClipOptions(**common))
        tres = torch_load(str(paths), TorchClipOptions(**common, device="cpu"))
    assert tres["test_index"].violence_detector is not None
    return {"jax": jax_make_app(jres), "torch": torch_make_app(tres, device="cpu"), "x": x, "paths": str(paths)}


def _both(served, method, path, body=None):
    return request(served["jax"], method, path, body), request(served["torch"], method, path, body)


def _knn(served, **body):
    body = {"modality": "image", "indice_name": "test_index", **body}
    rj, rt = _both(served, "POST", "/knn-service", body)
    assert rj["status"].startswith("200"), rj["body"]
    assert rt["status"].startswith("200"), rt["body"]
    return rj["json"], rt["json"]


def _same_results(rj, rt):
    assert [r["id"] for r in rt] == [r["id"] for r in rj]
    np.testing.assert_allclose([r["similarity"] for r in rt], [r["similarity"] for r in rj], atol=SIM_ATOL, rtol=0)
    for a, b in zip(rj, rt):
        assert {k: v for k, v in a.items() if k != "similarity"} == {k: v for k, v in b.items() if k != "similarity"}


@pytest.mark.parametrize(
    "body",
    [
        {"text": "an orange cat", "num_images": 7},
        {"text": "a photo of a dog on the beach", "num_images": 12, "deduplicate": True},
        {"image": _jpeg_b64((0, 120, 255)), "num_images": 3},
        {"image": _jpeg_b64((230, 40, 20)), "num_images": 9},
    ],
    ids=["text", "text-dedup", "image-blue", "image-red"],
)
def test_encoded_queries_match_jax(served, body):
    rj, rt = _knn(served, **body)
    assert len(rt) == body["num_images"]
    _same_results(rj, rt)


def test_embedding_query_matches_jax(served):
    rj, rt = _knn(served, embedding_input=served["x"][42].tolist(), num_images=5)
    _same_results(rj, rt)
    assert rt[0]["id"] == 42 and rt[0]["similarity"] > 0.99


def test_dedup_matches_jax(served):
    q = served["x"][10].tolist()
    rj, rt = _knn(served, embedding_input=q, num_images=20, deduplicate=False)
    _same_results(rj, rt)
    assert {10, 11, 12} <= {r["id"] for r in rt}
    rj, rt = _knn(served, embedding_input=q, num_images=20, deduplicate=True)
    _same_results(rj, rt)
    assert len({10, 11, 12} & {r["id"] for r in rt}) == 1


def test_violence_detector_from_local_file_matches_jax(served):
    q = served["x"][3].tolist()
    rj, rt = _knn(served, embedding_input=q, num_images=10, use_violence_detector=True)
    _same_results(rj, rt)
    assert 3 not in {r["id"] for r in rt}  # flagged as violent by the prompt file
    _, plain = _knn(served, embedding_input=q, num_images=10)
    assert plain[0]["id"] == 3


@pytest.mark.parametrize(
    "method,path,body",
    [
        ("POST", "/metadata", {"ids": [0, 5, 7], "indice_name": "test_index"}),
        ("GET", "/indices-list", None),
        ("GET", "/config.json", None),
        ("GET", "/health", None),
    ],
)
def test_json_endpoints_match_jax(served, method, path, body):
    rj, rt = _both(served, method, path, body)
    assert rt["status"].startswith("200")
    assert rt["json"] == rj["json"]
    if path == "/metadata":
        assert "image" in rt["json"][0]["metadata"]  # id 0's image_path exists → base64


def test_empty_query_is_400_in_both(served):
    rj, rt = _both(served, "POST", "/knn-service", {"modality": "image", "num_images": 5,
                                                      "indice_name": "test_index"})
    assert rj["status"].startswith("400") and rt["status"].startswith("400")


def test_metrics_of_both_packages_in_one_process(served):
    """Each package renders its own histograms on /metrics: the port's live in
    its own registry, so neither import strips the other's."""
    _knn(served, text="metrics probe", num_images=2)
    for r in _both(served, "GET", "/metrics"):
        assert r["status"].startswith("200")
        body = r["body"].decode()
        count = re.search(r"^full_knn_request_time_count (\S+)$", body, re.M)
        assert count and float(count.group(1)) >= 1, body[:300]
        assert "text_clip_inference_time_count" in body
    for r in _both(served, "GET", "/metrics-summary"):
        assert r["status"].startswith("200")
        assert re.match(r"Among \d+ calls to the knn end point with an average latency of \d+\.\d{4}s per request",
                        r["body"].decode())


def test_serving_stats_and_stage_times(served):
    _knn(served, text="a stats query", num_images=3)
    rj, rt = _both(served, "GET", "/serving-stats")
    assert rt["status"].startswith("200")
    for stats in (rj["json"], rt["json"]):
        enc = stats["encoders"]["test_index"]
        assert enc["text"]["batches"] >= 1 and enc["text"]["items"] >= enc["text"]["batches"]
        assert sum(enc["text"]["batch_sizes"].values()) == enc["text"]["batches"]
        assert stats["search"]
    assert rt["json"].keys() == rj["json"].keys()
    r = request(served["torch"], "POST", "/stage-times", {"text_bucket": 3, "search_bucket": 2, "iters": 2, "k": 5})
    assert r["status"].startswith("200"), r["body"]
    st = r["json"]
    assert st["text_encode"]["bucket"] == 4 and st["text_encode"]["p50_ms"] > 0
    assert st["search"] == {"batch": 2, "k": 5, "p50_ms": st["search"]["p50_ms"]} and st["search"]["p50_ms"] > 0
    assert request(served["torch"], "POST", "/stage-times", {"indice_name": "nope"})["status"].startswith("400")
    # the TPU relay probe is not ported
    assert request(served["torch"], "GET", "/device-rtt")["status"].startswith("404")


def test_back_cli_serves_over_http_on_cpu(served):
    """`clip-retrieval-tpu-torch back --device cpu` boots (load, warm-up) and
    answers over a real socket."""
    import http.client
    import socket
    import threading
    import time

    from clip_retrieval_tpu_torch import cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["back", "--indices_paths", served["paths"], "--port", str(port), "--clip_model", "test-tiny",
            "--device", "cpu", "--provide_aesthetic_embeddings", "False", "--http_backend", "wsgiref"]
    threading.Thread(target=cli.main, args=(argv,), daemon=True).start()

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    deadline = time.monotonic() + 120
    while True:
        try:
            status, res = post("/knn-service", {"embedding_input": served["x"][42].tolist(), "num_images": 3,
                                                "indice_name": "test_index"})
            break
        except OSError:
            assert time.monotonic() < deadline, "the back entry point did not come up"
            time.sleep(0.2)
    assert status == 200 and res[0]["id"] == 42 and res[0]["caption"] == "caption 42"


def test_aiohttp_front_serves_the_same_routes(served):
    """`serve(..., http_backend="aiohttp")` over the port's router, /metrics
    (the WSGI mount) included."""
    pytest.importorskip("aiohttp")
    import http.client
    import socket
    import threading
    import time

    from clip_retrieval_tpu_torch.back.app import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=serve, args=(served["torch"], port, "127.0.0.1", "aiohttp"), daemon=True).start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    deadline = time.monotonic() + 60
    while True:
        try:
            status, body = call("GET", "/health")
            break
        except OSError:
            assert time.monotonic() < deadline, "the aiohttp server did not come up"
            time.sleep(0.1)
    assert status == 200 and json.loads(body) == "ok"
    status, body = call("POST", "/knn-service", {"embedding_input": served["x"][9].tolist(), "num_images": 3,
                                                 "indice_name": "test_index"})
    assert status == 200 and json.loads(body)[0]["id"] == 9
    assert call("POST", "/knn-service", {"num_images": 1})[0] == 400
    status, body = call("GET", "/metrics")
    assert status == 200 and b"full_knn_request_time_count" in body


def test_safety_heads_load_from_local_files(tmp_path, monkeypatch):
    """npz in the package cache, the reference's torch H14 checkpoint, and
    the aesthetic rating files, all from HOME; nothing else is fetched."""
    torch = pytest.importorskip("torch")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert t_safety.load_safety_model("ViT-L/14", device="cpu") is None
    mlp = t_safety.MLP.random(D, seed=5, device="cpu")
    t_safety.save_mlp_npz(f"{t_safety.cache_folder('ViT-L/14')}/nsfw_mlp.npz",
                          [(w.numpy(), b.numpy()) for w, b in mlp.weights])
    emb = _unit(np.random.default_rng(6).normal(size=(4, D)))
    np.testing.assert_array_equal(t_safety.load_safety_model("ViT-L/14", device="cpu").predict(emb), mlp.predict(emb))

    # the H14 head's shape: ReLU after every layer but the last two
    layers = torch.nn.Sequential(torch.nn.Linear(D, 16), torch.nn.ReLU(), torch.nn.Linear(16, 8), torch.nn.Linear(8, 1))
    h14 = tmp_path / ".cache" / "clip_retrieval" / "h14_nsfw_model" / "model.pt"
    h14.parent.mkdir(parents=True)
    torch.save({f"layers.{k}": v for k, v in layers.state_dict().items()}, h14)
    got = t_safety.load_safety_model("open_clip:ViT-H-14", device="cpu").predict(emb)
    with torch.no_grad():
        np.testing.assert_allclose(got, layers(torch.from_numpy(emb)).numpy(), rtol=1e-5, atol=1e-6)

    assert t_safety.get_aesthetic_embedding("ViT-L/14") is None
    folder = tmp_path / ".cache" / "clip_retrieval" / "ViT-L_14" / "aesthetic"  # the reference's layout
    folder.mkdir(parents=True)
    for k in range(10):
        np.save(folder / f"rating{k}.npy", np.full((1, D), k, np.float32))
    embs = t_safety.get_aesthetic_embedding("ViT-L/14")
    assert sorted(embs) == list(range(10)) and embs[7][0, 0] == 7


def test_safety_mlp_npz_written_by_jax_loads_in_the_port(tmp_path):
    from clip_retrieval_tpu.models import safety as j_safety

    jm = j_safety.JaxMLP.random(D, seed=3)
    path = str(tmp_path / "nsfw_mlp.npz")
    j_safety.save_mlp_npz(path, [(np.asarray(w), np.asarray(b)) for w, b in jm.weights],
                          final_activation="sigmoid", relu_last_n_skipped=1)
    tm = t_safety.load_mlp_npz(path, device="cpu")
    jm2 = j_safety.load_mlp_npz(path)
    emb = _unit(np.random.default_rng(4).normal(size=(6, D)))
    np.testing.assert_allclose(tm.predict(emb), jm2.predict(emb), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(t_safety.MLP.random(D, seed=3, device="cpu").predict(emb), jm.predict(emb), atol=1e-5, rtol=1e-5)


# -- ClipClient over a real socket ---------------------------------------------


@pytest.fixture(scope="module")
def live_port(served):
    """The port's app on a wsgiref socket server (daemon thread)."""
    import http.client
    import socket
    import threading
    import time

    from clip_retrieval_tpu_torch.back.app import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=serve, args=(served["torch"], port, "127.0.0.1", "wsgiref"), daemon=True).start()
    deadline = time.monotonic() + 60
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            assert conn.getresponse().status == 200
            conn.close()
            return port
        except OSError:
            assert time.monotonic() < deadline, "the wsgiref server did not come up"
            time.sleep(0.1)


@pytest.mark.parametrize("kind", ["text", "image", "embedding"])
def test_clip_client_matches_jax_client_and_raw_http(served, live_port, tmp_path, kind):
    """The port's `ClipClient` against the port's `back` over a socket: the
    JAX package's client and a raw POST with the same body get the same
    answers."""
    import http.client

    from clip_retrieval_tpu.client import ClipClient as JClient
    from clip_retrieval_tpu_torch.client import ClipClient, Modality

    url = f"http://127.0.0.1:{live_port}/knn-service"
    opts = dict(indice_name="test_index", num_images=6, deduplicate=False, use_safety_model=False,
                use_violence_detector=False)
    if kind == "text":
        query = {"text": "a photo of a red bus"}
    elif kind == "image":
        path = tmp_path / "q.jpg"
        path.write_bytes(base64.b64decode(_jpeg_b64((20, 200, 90))))
        query = {"image": str(path)}
    else:
        query = {"embedding_input": served["x"][17].tolist()}
    got = ClipClient(url, modality=Modality.IMAGE, **opts).query(**query)
    assert got == JClient(url, **opts).query(**query)
    body = {"indice_name": "test_index", "num_images": 6, "num_result_ids": 6, "modality": "image",
            "deduplicate": False, "use_safety_model": False, "use_violence_detector": False,
            "aesthetic_score": 9, "aesthetic_weight": 0.5, "use_mclip": False}
    if kind == "image":
        body["image"] = base64.b64encode(path.read_bytes()).decode()
    else:
        body.update(query)
    conn = http.client.HTTPConnection("127.0.0.1", live_port, timeout=30)
    try:
        conn.request("POST", "/knn-service", body=json.dumps(body), headers={"Content-Type": "application/json"})
        raw = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    assert got == raw and len(got) == 6
    assert {"id", "similarity", "caption", "url"} <= set(got[0])
    if kind == "embedding":
        assert got[0]["id"] == 17


def test_clip_client_rejects_two_or_no_inputs():
    from clip_retrieval_tpu_torch.client import ClipClient

    client = ClipClient("http://127.0.0.1:9/knn-service")
    with pytest.raises(ValueError, match="Only one"):
        client.query(text="a", image="b")
    with pytest.raises(ValueError, match="Either text or image"):
        client.query()


def test_hash_based_dedup_matches_jax(served):
    from clip_retrieval_tpu.back.knn import KnnService as JKnn
    from clip_retrieval_tpu_torch.back.knn import KnnService as TKnn

    emb = served["x"][:40].copy()
    emb[[5, 9]] = emb[3]  # exact repeats
    emb[20] = emb[2] + 1e-4  # equal after rounding to 2 decimals
    got = TKnn.hash_based_dedup(emb)
    assert got == JKnn.hash_based_dedup(emb) and {5, 9, 20} <= set(got)


# -- IVF-reordered metadata, prepared by either package, served by the other ----


@pytest.fixture(scope="module")
def reordered(tmp_path_factory):
    """An IVF16,PQ16 index built by the JAX `clip_index` over 600 clustered
    rows, in two copies: one prepared for reordered serving by the JAX
    package's `load_clip_indices`, one by the port's."""
    import shutil

    root = tmp_path_factory.mktemp("reorder")
    emb = root / "emb"
    (emb / "img_emb").mkdir(parents=True)
    (emb / "metadata").mkdir(parents=True)
    rng = np.random.default_rng(1)
    n = 600
    centers = _unit(rng.normal(size=(8, D)))
    x = _unit(centers[rng.integers(0, 8, n)] + 0.2 * rng.normal(size=(n, D)))
    np.save(emb / "img_emb" / "img_emb_0.npy", x.astype(np.float16))
    pd.DataFrame({"caption": [f"cap {i}" for i in range(n)],
                  "url": [f"http://x/{i}" for i in range(n)]}).to_parquet(emb / "metadata" / "metadata_0.parquet")
    clip_index(str(emb), str(root / "built"), index_key="IVF16,PQ16", nprobe=16, compute_recall=False)
    common = dict(clip_model="test-tiny", columns_to_return=["caption", "url"], enable_hdf5=True,
                  reorder_metadata_by_ivf_index=True, provide_aesthetic_embeddings=False)
    out = {"x": x, "root": root}
    for name in ("jax", "torch"):
        shutil.copytree(root / "built", root / name)
        (root / f"{name}.json").write_text(json.dumps({"r": str(root / name)}))
    # each package prepares its own copy, then serves the other's
    out["apps"] = {
        ("jax", "jax"): jax_make_app(jax_load(str(root / "jax.json"), JaxClipOptions(**common))),
        ("torch", "torch"): torch_make_app(torch_load(str(root / "torch.json"), TorchClipOptions(**common,
                                                                                                 device="cpu")),
                                           device="cpu"),
    }
    out["apps"][("torch", "jax")] = torch_make_app(torch_load(str(root / "jax.json"), TorchClipOptions(
        **common, device="cpu")), device="cpu")
    out["apps"][("jax", "torch")] = jax_make_app(jax_load(str(root / "torch.json"), JaxClipOptions(**common)))
    out["resources"] = torch_load(str(root / "torch.json"), TorchClipOptions(**common, device="cpu"))["r"]
    return out


def test_reordered_artifacts_are_byte_equal(reordered):
    res = reordered["resources"]
    assert res.metadata_is_ordered_by_ivf
    m = np.asarray(res.ivf_old_to_new_mapping)
    np.testing.assert_array_equal(np.sort(m), np.arange(len(m)))
    for artifact in ("ivf_old_to_new_mapping.npy", "metadata_reordered.hdf5"):
        assert (reordered["root"] / "torch" / artifact).read_bytes() == \
            (reordered["root"] / "jax" / artifact).read_bytes(), artifact


@pytest.mark.parametrize("row", [123, 7, 450])
def test_reordered_folders_serve_alike_in_both_packages(reordered, row):
    """(serving package, preparing package): every pair answers with the same
    ids and the same metadata per result, and the metadata is the original
    row's."""
    body = {"embedding_input": reordered["x"][row].tolist(), "modality": "image", "num_images": 5,
            "indice_name": "r"}
    answers = {}
    for key, app in reordered["apps"].items():
        r = request(app, "POST", "/knn-service", body)
        assert r["status"].startswith("200"), (key, r["body"])
        answers[key] = r["json"]
    want = answers[("jax", "jax")]
    for key, got in answers.items():
        assert [a["id"] for a in got] == [w["id"] for w in want], key
        assert [(a["caption"], a["url"]) for a in got] == [(w["caption"], w["url"]) for w in want], key
        np.testing.assert_allclose([a["similarity"] for a in got], [w["similarity"] for w in want], atol=1e-5)
    assert f"cap {row}" in [a["caption"] for a in want]  # under PQ distortion the row ranks within the top few


def test_reordered_dynamic_nprobe_is_restored(reordered):
    res = reordered["resources"]
    app = torch_make_app({"r": res}, device="cpu")
    before = res.image_index.nprobe
    r = request(app, "POST", "/knn-service", {"embedding_input": reordered["x"][0].tolist(), "modality": "image",
                                              "num_images": 3, "num_result_ids": 150000, "indice_name": "r"})
    assert r["status"].startswith("200")
    assert res.image_index.nprobe == before
