"""clip-front: static web UI server + /config.json.

Copy of `clip_retrieval_tpu/front.py`: `add_static_routes`, which the port's
`back/app.py` registers on its router, and `clip_front`, which serves the
same routes standalone (no device).  The SPA itself is a data directory at
the root of the checkout (`front/`), shared by both packages; CRT_FRONT_DIR
points elsewhere.
"""

from __future__ import annotations

import mimetypes
import os
from pathlib import Path

_FRONT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "front")


def _front_dir() -> str:
    env = os.environ.get("CRT_FRONT_DIR")
    if env and os.path.isdir(env):
        return env
    return _FRONT_DIR


def add_static_routes(router, default_backend, default_index, url_column):
    """Register /, /index.html, asset files and /config.json on a WsgiRouter."""
    config = {"defaultBackend": default_backend, "defaultIndex": default_index, "urlColumn": url_column or "url"}
    router.route("GET", "/config.json", lambda: config)

    front = Path(_front_dir())
    if not front.is_dir():
        return

    def file_handler(path: Path):
        ctype = mimetypes.guess_type(str(path))[0] or "application/octet-stream"

        def handler():
            return path.read_bytes(), ctype

        return handler

    for p in front.rglob("*"):
        if p.is_file():
            rel = "/" + p.relative_to(front).as_posix()
            if rel == "/config.json":
                # the dynamic /config.json carries the configured backend and
                # index; a stale file shipped in the front build must not shadow it
                continue
            router.route("GET", rel, file_handler(p))
            if rel == "/index.html":
                router.route("GET", "/", file_handler(p))


def clip_front(
    default_backend: str | None = None,
    default_index: str | None = None,
    url_column: str = "url",
    port: int = 1235,
):
    """Serve the static front end standalone."""
    from .back.app import WsgiRouter, serve

    router = WsgiRouter()
    add_static_routes(router, default_backend, default_index, url_column)
    serve(router, port)
