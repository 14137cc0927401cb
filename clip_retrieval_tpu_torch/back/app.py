"""clip-back HTTP app: stdlib WSGI, same endpoints/JSON as the JAX package.

Counterpart of `clip_retrieval_tpu/back/app.py`: the same REST surface
(`/knn-service`, `/metadata`, `/indices-list`, `/health`, `/metrics`,
`/metrics-summary`, `/serving-stats`, `/stage-times`, static front +
`/config.json`) from a dependency-free WSGI router, served by wsgiref or
aiohttp.  `/metrics` renders this package's own prometheus registry.  The
JAX package's `/device-rtt` probe is not ported: it measured a TPU relay.
"""

from __future__ import annotations

import json
import logging
import os
import traceback
from typing import Any, Callable, Dict

import torch
from prometheus_client import make_wsgi_app

from ..front import add_static_routes
from ..utils.device import resolve_device
from .knn import KnnService, MetadataService
from .metrics import REGISTRY, metrics_summary_text
from .options import ClipOptions
from .resources import load_clip_indices

LOGGER = logging.getLogger("clip_back")

_CORS_HEADERS = [
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Headers", "Content-Type"),
    ("Access-Control-Allow-Methods", "GET, POST, OPTIONS"),
]


class WsgiRouter:
    """Tiny exact-path WSGI router with CORS + JSON helpers."""

    def __init__(self):
        self.routes: Dict[tuple[str, str], Callable] = {}
        self.wsgi_mounts: Dict[str, Callable] = {}
        self.fallback: Callable | None = None

    def route(self, method: str, path: str, fn: Callable):
        self.routes[(method, path)] = fn

    def mount(self, path: str, wsgi_app: Callable):
        self.wsgi_mounts[path] = wsgi_app

    def __call__(self, environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")
        if method == "OPTIONS":
            start_response("204 No Content", list(_CORS_HEADERS))
            return [b""]
        for mount, app in self.wsgi_mounts.items():
            if path == mount or path.startswith(mount + "/"):
                environ = dict(environ)
                environ["SCRIPT_NAME"] = mount
                environ["PATH_INFO"] = path[len(mount) :]
                return app(environ, start_response)
        handler = self.routes.get((method, path))
        if handler is None and self.fallback is not None:
            return self.fallback(environ, start_response)
        if handler is None:
            start_response("404 Not Found", [("Content-Type", "application/json"), *_CORS_HEADERS])
            return [json.dumps({"error": "not found"}).encode()]
        try:
            body = None
            if method == "POST":
                length = int(environ.get("CONTENT_LENGTH") or 0)
                raw = environ["wsgi.input"].read(length) if length else b"{}"
                body = json.loads(raw or b"{}")
            result = handler(body) if method == "POST" else handler()
            if isinstance(result, tuple):  # (payload, content_type)
                payload, ctype = result
                data = payload if isinstance(payload, bytes) else str(payload).encode()
            else:
                ctype = "application/json"
                data = json.dumps(result).encode()
            start_response("200 OK", [("Content-Type", ctype), *_CORS_HEADERS])
            return [data]
        except ValueError as e:
            start_response("400 Bad Request", [("Content-Type", "application/json"), *_CORS_HEADERS])
            return [json.dumps({"error": str(e)}).encode()]
        except Exception as e:  # pragma: no cover
            LOGGER.error("request failed: %s", traceback.format_exc())
            start_response("500 Internal Server Error", [("Content-Type", "application/json"), *_CORS_HEADERS])
            return [json.dumps({"error": str(e)}).encode()]


def make_app(
    clip_resources: Dict[str, Any],
    default_backend: str | None = None,
    default_index: str | None = None,
    url_column: str = "url",
    device: str | torch.device = "cuda",
) -> WsgiRouter:
    """Assemble the WSGI app from loaded resources."""
    router = WsgiRouter()
    knn = KnnService(clip_resources, device)
    meta = MetadataService(clip_resources)
    router._knn = knn  # exposed for warmup/tests

    router.route("POST", "/knn-service", knn.handle_post)
    router.route("POST", "/metadata", meta.handle_post)
    router.route("GET", "/indices-list", lambda: list(clip_resources.keys()))
    router.route("GET", "/health", lambda: "ok")
    router.route("GET", "/metrics-summary", lambda: (metrics_summary_text(), "text/plain"))
    router.route("GET", "/serving-stats", knn.serving_stats)
    router.route("POST", "/stage-times", knn.stage_times)
    router.mount("/metrics", make_wsgi_app(REGISTRY))
    add_static_routes(router, default_backend, default_index, url_column)
    return router


def serve(app: WsgiRouter, port: int, host: str = "0.0.0.0", http_backend: str = "auto", worker_threads: int = 64):
    """Serve the router.

    http_backend:
      - "aiohttp" — async event loop; handlers run in a thread pool (device
        work batches via the MicroBatchers);
      - "wsgiref" — stdlib thread-per-connection server, zero deps;
      - "auto"    — aiohttp when importable, else wsgiref.
    """
    if http_backend == "auto":
        try:
            import aiohttp  # noqa: F401

            http_backend = "aiohttp"
        except ImportError:
            http_backend = "wsgiref"
    if http_backend == "aiohttp":
        return _serve_aiohttp(app, port, host, worker_threads)
    import socketserver
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True
        # default backlog of 5 resets connections under concurrent load
        request_queue_size = 512

    class LoggingHandler(WSGIRequestHandler):
        def log_message(self, format, *args):  # access log to the logger, not stderr
            LOGGER.info("%s %s", self.address_string(), format % args)

    with make_server(host, port, app, server_class=ThreadingWSGIServer, handler_class=LoggingHandler) as srv:
        LOGGER.info("serving on %s:%d (wsgiref)", host, port)
        srv.serve_forever()


def _serve_aiohttp(router: WsgiRouter, port: int, host: str, worker_threads: int):
    """Async front end over the same route table."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from aiohttp import web

    pool = ThreadPoolExecutor(max_workers=worker_threads)

    def make_handler(fn, is_post: bool):
        async def handler(request: "web.Request") -> "web.Response":
            loop = asyncio.get_running_loop()
            try:
                if is_post:
                    body = await request.json() if request.can_read_body else {}
                    result = await loop.run_in_executor(pool, fn, body)
                else:
                    result = await loop.run_in_executor(pool, fn)
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400, headers=dict(_CORS_HEADERS))
            except Exception as e:
                LOGGER.error("request failed: %s", traceback.format_exc())
                return web.json_response({"error": str(e)}, status=500, headers=dict(_CORS_HEADERS))
            if isinstance(result, tuple):
                payload, ctype = result
                data = payload if isinstance(payload, bytes) else str(payload).encode()
                return web.Response(body=data, content_type=ctype.split(";")[0], headers=dict(_CORS_HEADERS))
            return web.json_response(result, headers=dict(_CORS_HEADERS))

        return handler

    async def options_handler(request):
        return web.Response(status=204, headers=dict(_CORS_HEADERS))

    app = web.Application(client_max_size=64 * 1024 * 1024)
    for (method, path), fn in router.routes.items():
        app.router.add_route(method, path, make_handler(fn, method == "POST"))
        app.router.add_route("OPTIONS", path, options_handler)
    for mount, wsgi_app in router.wsgi_mounts.items():
        # prometheus /metrics: tiny WSGI app driven inline
        def make_wsgi_handler(wapp, mount=mount):
            async def handler(request):
                environ = {
                    "REQUEST_METHOD": "GET",
                    "PATH_INFO": "",
                    "SCRIPT_NAME": mount,
                    "QUERY_STRING": request.query_string,
                    "SERVER_NAME": host,
                    "SERVER_PORT": str(port),
                    "wsgi.input": None,
                    "wsgi.errors": None,
                    "wsgi.url_scheme": "http",
                }
                captured = {}

                def start_response(status, headers):
                    captured["status"] = int(status.split()[0])
                    captured["headers"] = headers

                chunks = wapp(environ, start_response)
                return web.Response(
                    body=b"".join(chunks),
                    status=captured.get("status", 200),
                    headers=dict(captured.get("headers", [])) | dict(_CORS_HEADERS),
                )

            return handler

        app.router.add_route("GET", mount, make_wsgi_handler(wsgi_app))
    LOGGER.info("serving on %s:%d (aiohttp)", host, port)
    web.run_app(app, host=host, port=port, print=None, handle_signals=False)


def clip_back(
    indices_paths: str = "indices_paths.json",
    port: int = 1234,
    enable_hdf5: bool = False,
    enable_faiss_memory_mapping: bool = False,
    columns_to_return=None,
    reorder_metadata_by_ivf_index: bool = False,
    default_backend: str | None = None,
    url_column: str = "url",
    enable_mclip_option: bool = False,
    mclip_model: str = "",
    clip_model: str = "ViT-B/32",
    checkpoint: str | None = None,
    use_jit: bool = True,
    use_arrow: bool = False,
    provide_safety_model: bool = False,
    provide_violence_detector: bool = False,
    provide_aesthetic_embeddings: bool = True,
    http_backend: str = "auto",
    device: str = "cuda",
):
    """Main entry point: load indices onto `device` and serve."""
    resolve_device(device)  # fail before any work when the GPU is missing
    print("starting boot of clip back")
    if columns_to_return is None:
        columns_to_return = ["url", "image_path", "caption", "NSFW"]
    clip_resources = load_clip_indices(
        indices_paths=indices_paths,
        clip_options=ClipOptions(
            indice_folder="",
            clip_model=clip_model,
            checkpoint=checkpoint,
            enable_hdf5=enable_hdf5,
            enable_faiss_memory_mapping=enable_faiss_memory_mapping,
            columns_to_return=columns_to_return,
            reorder_metadata_by_ivf_index=reorder_metadata_by_ivf_index,
            enable_mclip_option=enable_mclip_option,
            mclip_model=mclip_model,
            use_jit=use_jit,
            use_arrow=use_arrow,
            provide_safety_model=provide_safety_model,
            provide_violence_detector=provide_violence_detector,
            provide_aesthetic_embeddings=provide_aesthetic_embeddings,
            device=device,
        ),
    )
    print("indices loaded")
    app = make_app(clip_resources, default_backend, None, url_column, device)
    warmup_app(app, clip_resources)
    serve(app, port, http_backend=http_backend)


def warm_buckets_from_env() -> tuple:
    """Micro-batch bucket sizes to warm at boot, from CRT_WARM_BUCKETS
    (comma-separated ints, default "1,64"; empty string disables warmup).
    Malformed entries are skipped with a warning."""
    raw = os.environ.get("CRT_WARM_BUCKETS", "1,64")
    if not raw.strip():
        return ()
    out = []
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            val = int(tok)
        except ValueError:
            print(f"ignoring malformed CRT_WARM_BUCKETS entry {tok!r}")
            continue
        if val < 1:
            print(f"ignoring non-positive CRT_WARM_BUCKETS entry {tok!r}")
            continue
        out.append(val)
    if not out:
        # a fully-malformed value must not silently disable warmup
        print("CRT_WARM_BUCKETS had no valid entries; using default 1,64")
        return (1, 64)
    return tuple(out)


def warmup_app(app, clip_resources) -> None:
    """Run one query per index and the encoders at the warm buckets, so the
    first real request pays no kernel build or first-call cost."""
    buckets = warm_buckets_from_env()
    for name in clip_resources:
        try:
            app._knn.query(
                text_input="warmup",
                modality="image" if clip_resources[name].image_index is not None else "text",
                num_images=1,
                num_result_ids=1,
                indice_name=name,
                deduplicate=False,
            )
            if buckets:
                app._knn._enc(name).warm(buckets)
            print(f"warmed index {name!r}")
        except Exception as e:
            print(f"warmup for {name!r} failed: {e}")
