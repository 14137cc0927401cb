"""kNN REST backend (drop-in /knn-service API) + metadata providers."""

from .app import clip_back  # noqa: F401
