"""ClipClient: typed remote wrapper over the /knn-service REST endpoint.

Counterpart of `clip_retrieval_tpu/client.py` (pure HTTP, copied; it needs
`requests` and touches no device): the reference client's constructor
options and `query(text|image|embedding_input)` surface, local image files
base64-encoded client-side, `num_result_ids` pinned to `num_images`, a
pooled `requests.Session` (keep-alive across queries) and a configurable
timeout.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
from pathlib import Path
from typing import Dict, List, Optional


class Modality(enum.Enum):
    IMAGE = "image"
    TEXT = "text"


@dataclasses.dataclass
class ClipClient:
    """Query a clip-back server.

    url: backend endpoint (".../knn-service").
    indice_name: which index to search (e.g. "laion5B").
    use_mclip: multilingual text encoding server-side.
    aesthetic_score/weight: query steering toward a rating embedding.
    modality: search the image or the text index.
    num_images: results to return per query.
    deduplicate / use_safety_model / use_violence_detector: post filters.
    timeout: per-request timeout in seconds.
    """

    url: str
    indice_name: Optional[str] = None
    use_mclip: bool = False
    aesthetic_score: int = 9
    aesthetic_weight: float = 0.5
    modality: Modality = Modality.IMAGE
    num_images: int = 40
    deduplicate: bool = True
    use_safety_model: bool = True
    use_violence_detector: bool = True
    timeout: float = 3600.0

    def __post_init__(self):
        import requests

        self._session = requests.Session()

    # -- public ------------------------------------------------------------

    def query(
        self,
        text: Optional[str] = None,
        image: Optional[str] = None,
        embedding_input: Optional[list] = None,
    ) -> List[Dict]:
        """Semantic search by text, image (local path or http url), or a raw
        embedding. Exactly one input must be given."""
        if text and image:
            raise ValueError("Only one of text or image can be provided.")
        if text:
            return self._post(text=text)
        if image:
            if image.startswith("http"):
                return self._post(image_url=image)
            path = Path(image)
            assert path.exists(), f"{image} does not exist."
            encoded = base64.b64encode(path.read_bytes()).decode("utf-8")
            return self._post(image=encoded)
        if embedding_input:
            return self._post(embedding_input=embedding_input)
        raise ValueError("Either text or image must be provided.")

    # -- internals -----------------------------------------------------------

    def _post(self, **inputs) -> List[Dict]:
        payload = {
            "text": None,
            "image": None,
            "image_url": None,
            "embedding_input": None,
            **inputs,
            "deduplicate": self.deduplicate,
            "use_safety_model": self.use_safety_model,
            "use_violence_detector": self.use_violence_detector,
            "indice_name": self.indice_name,
            "use_mclip": self.use_mclip,
            "aesthetic_score": self.aesthetic_score,
            "aesthetic_weight": self.aesthetic_weight,
            "modality": self.modality.value
            if isinstance(self.modality, Modality)
            else self.modality,
            "num_images": self.num_images,
            "num_result_ids": self.num_images,
        }
        resp = self._session.post(self.url, json=payload, timeout=self.timeout)
        return resp.json()
