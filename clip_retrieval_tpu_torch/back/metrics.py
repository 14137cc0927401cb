"""Prometheus instrumentation for the serving path.

Counterpart of `clip_retrieval_tpu/back/metrics.py`: the same ten histograms
with the same names, and the same /metrics-summary ranked cost table.  They
live in this package's own `REGISTRY` (a `CollectorRegistry`), which
`/metrics` renders: both packages can then run their apps in one process
without a "Duplicated timeseries" clash on prometheus_client's global
registry, and neither strips the other's histograms.
"""

from __future__ import annotations

from prometheus_client import CollectorRegistry, Histogram

REGISTRY = CollectorRegistry()


def _histogram(name: str, doc: str) -> Histogram:
    return Histogram(name, doc, registry=REGISTRY)


FULL_KNN_REQUEST_TIME = _histogram("full_knn_request_time", "Time spent processing knn request")
DOWNLOAD_TIME = _histogram("download_time", "Time spent downloading an url")
TEXT_CLIP_INFERENCE_TIME = _histogram("text_clip_inference_time", "Time spent doing a text clip inference")
IMAGE_CLIP_INFERENCE_TIME = _histogram("image_clip_inference_time", "Time spent doing a image clip inference")
METADATA_GET_TIME = _histogram("metadata_get_time", "Time spent retrieving metadata")
KNN_INDEX_TIME = _histogram("knn_index_time", "Time spent doing a knn on the index")
DEDUP_TIME = _histogram("dedup_time", "Time spent deduping")
SAFETY_TIME = _histogram("safety_time", "Time spent doing a safety inference")
IMAGE_PREPRO_TIME = _histogram("image_prepro_time", "Time spent doing the image preprocessing")
TEXT_PREPRO_TIME = _histogram("text_prepro_time", "Time spent doing the text preprocessing")

_SUB_METRICS = [
    DOWNLOAD_TIME,
    TEXT_CLIP_INFERENCE_TIME,
    IMAGE_CLIP_INFERENCE_TIME,
    METADATA_GET_TIME,
    KNN_INDEX_TIME,
    DEDUP_TIME,
    SAFETY_TIME,
    IMAGE_PREPRO_TIME,
    TEXT_PREPRO_TIME,
]


def metric_to_average(metric: Histogram):
    data = metric.collect()[0]
    name, desc = data.name, data.documentation
    total = count = 0.0
    for sample in data.samples:
        if sample.name == name + "_sum":
            total = sample.value
        elif sample.name == name + "_count":
            count = sample.value
    if count == 0:
        return name, desc, 0, 0.0
    return name, desc, count, total / count


def metrics_summary_text() -> str:
    """Human-readable ranked per-stage cost table."""
    import pandas as pd

    _, _, knn_count, knn_avg = metric_to_average(FULL_KNN_REQUEST_TIME)
    if knn_count == 0:
        return "No request yet, go do some"
    rows = sorted([metric_to_average(m) for m in _SUB_METRICS], key=lambda e: -e[3])
    table = [
        (name, desc, int(count), f"{avg:0.4f}s", f"{avg / knn_avg * 100:0.1f}%")
        for name, desc, count, avg in rows
    ]
    df = pd.DataFrame(table, columns=("name", "description", "calls", "average", "proportion"))
    return (
        f"Among {int(knn_count)} calls to the knn end point with an average "
        f"latency of {knn_avg:0.4f}s per request, the step costs are "
        "(in order): \n\n" + df.to_string()
    )
