"""Index parameter auto-selection from a memory budget.

Copy of `clip_retrieval_tpu/index/autotune.py` (pure Python; the tier
thresholds and byte costings are the JAX package's, not yet re-measured on
the H100).  Plays autofaiss's role in the reference (its
`clip_retrieval/clip_index.py:24-31`: build_index bounded by
max_index_memory_usage / current_memory_available).  Accepts faiss-style
index keys for explicit control ("Flat", "IVF4096,PQ64", "OPQ64,IVF4096,PQ64")
and otherwise derives (nlist, m, opq) from corpus size and the byte budget.
"""

from __future__ import annotations

import dataclasses
import math
import re


@dataclasses.dataclass
class IndexParams:
    kind: str  # "flat" | "ivfpq"
    nlist: int = 0
    m: int = 0
    ksub: int = 256
    use_opq: bool = False
    use_refine: bool = False  # disk-mmap exact re-rank tier (RFlat)

    @property
    def index_key(self) -> str:
        if self.kind == "flat":
            return "Flat"
        if self.kind == "flat_int8":
            return "Flat8"
        if self.kind == "ivf_int8":
            key = f"IVF{self.nlist},Flat8"
            return key + ",RFlat" if self.use_refine else key
        key = f"IVF{self.nlist},PQ{self.m}x8"
        if self.use_opq:
            key = f"OPQ{self.m},{key}"
        if self.use_refine:
            key += ",RFlat"  # faiss refine-layer naming
        return key


def parse_memory_string(s: str | int | float) -> int:
    """'4G'/'500M'/'16GB' → bytes."""
    if isinstance(s, (int, float)):
        return int(s)
    m = re.fullmatch(r"\s*([\d.]+)\s*([KMGT]?)B?\s*", s, re.IGNORECASE)
    if not m:
        raise ValueError(f"bad memory string {s!r}")
    mult = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    return int(float(m.group(1)) * mult[m.group(2).upper()])


def parse_index_key(key: str, d: int) -> IndexParams:
    key = key.strip()
    if key.lower() == "flat":
        return IndexParams(kind="flat")
    if key.lower() in ("flat8", "flatint8", "flat_int8"):
        return IndexParams(kind="flat_int8")
    m_ivf8 = re.fullmatch(
        r"IVF(\d+),?(Flat8|INT8)(,?(RFlat|Refine))?", key, re.I
    )
    if m_ivf8:
        return IndexParams(
            kind="ivf_int8",
            nlist=int(m_ivf8.group(1)),
            use_refine=m_ivf8.group(3) is not None,
        )
    use_opq = False
    use_refine = False
    nlist = m = None
    for part in key.split(","):
        part = part.strip()
        if part.upper().startswith("OPQ"):
            use_opq = True
        elif part.upper().startswith("IVF"):
            nlist = int(re.match(r"IVF(\d+)", part, re.I).group(1))
        elif part.upper().startswith("PQ"):
            pm = re.fullmatch(r"PQ(\d+)(?:x(\d+))?", part, re.I)
            if pm is None:
                raise ValueError(f"unsupported PQ spec {part!r} in {key!r}")
            if pm.group(2) is not None and int(pm.group(2)) != 8:
                # silently treating PQ64x4 as 8-bit would double the memory
                # the faiss-style key was chosen for
                raise ValueError(
                    f"only 8-bit PQ codes are supported (got {part!r})"
                )
            m = int(pm.group(1))
        elif part.upper().startswith(("RFLAT", "REFINE")):
            use_refine = True
    if nlist is None or m is None:
        raise ValueError(f"unsupported index key {key!r}")
    if d % m:
        raise ValueError(f"PQ{m} does not divide d={d}")
    return IndexParams(
        kind="ivfpq", nlist=nlist, m=m, use_opq=use_opq,
        use_refine=use_refine,
    )


def _pick_nlist(n: int) -> int:
    """~8·√n coarse cells, power of two, clamped to [64, 131072]."""
    return 1 << max(6, min(17, round(math.log2(8 * math.sqrt(max(n, 1))))))


def _pick_m(d: int, budget_per_vec: float) -> int:
    candidates = [c for c in (256, 192, 128, 96, 64, 48, 32, 24, 16, 12, 8, 4)
                  if c <= d and d % c == 0]
    if not candidates:
        raise ValueError(
            f"d={d} has no supported PQ sub-quantizer count (needs a "
            "divisor in 4..256); pass an explicit index_key (e.g. Flat8) "
            "or pad the embedding dim"
        )
    for c in candidates:
        if c <= budget_per_vec:
            return c
    return candidates[-1]


def select_params(
    n: int,
    d: int,
    max_index_memory: str | int = "4G",
    index_key: str | None = None,
) -> IndexParams:
    """Choose index params for n d-dim vectors under a byte budget."""
    if index_key:
        return parse_index_key(index_key, d)
    budget = parse_memory_string(max_index_memory)
    flat_bytes = n * d * 2  # fp16 vectors
    if n <= 100_000 and flat_bytes <= budget:
        return IndexParams(kind="flat")
    # int8 tiers at full matmul rate: the preferred path whenever the quantized
    # corpus fits the budget (device HBM across local chips).  Brute force
    # (exact) up to 8M rows; past that each query batch would stream the
    # whole multi-GB corpus from HBM, so switch to IVF-int8 (scan only the
    # probed lists) with the exact re-rank tier recovering recall.  Each
    # tier is costed at its ACTUAL device-image bytes, not the raw corpus:
    # a boundary-sized corpus must not pass the check and then OOM.
    if n <= 8_000_000 and n * (d + 4) <= budget:  # int8 rows + f32 scale
        return IndexParams(kind="flat_int8")
    from .ivf_int8 import _chunk_len

    int8_nlist = _pick_nlist(n)
    # chunked-CSR image: int8 rows + f32 scale + i32 pos per row, expected
    # Lc/2 padding rows per list (each list wastes < Lc slots in its last
    # chunk; k-means-balanced lists land uniformly in [0, Lc), and the
    # adversarial all-lists-≡1-mod-Lc case cannot concentrate: skew means
    # few LONG lists, whose relative padding vanishes), + f32 centroids
    ivf_int8_bytes = (n + int8_nlist * _chunk_len(n, int8_nlist) // 2) * (
        d + 8
    ) + int8_nlist * d * 4
    if ivf_int8_bytes <= budget:
        return IndexParams(kind="ivf_int8", nlist=int8_nlist, use_refine=True)
    # IVF-PQ: per-vector cost ≈ m (codes) + 8 (id); fixed cost nlist*d*4
    nlist = _pick_nlist(n)
    while nlist > 64 and n / nlist < 39:  # faiss min points per centroid
        nlist //= 2
    per_vec = (budget - nlist * d * 4) / max(n, 1) - 8
    # with the refine tier on (below), recall is recovered by the exact
    # re-rank, so oversized codes only slow the scan: cap m at 64 bytes —
    # a generous budget must not autotune into a 4× slower ADC pass
    m = _pick_m(d, min(per_vec, 64.0))
    # default-on refine: ADC alone rarely clears recall@10 ≥ 0.95 (the
    # north-star, BASELINE.md); the exact re-rank store is fp16 on DISK
    # and mmap'd (rerank_factor·k row reads per query), so it does not
    # count against max_index_memory (which bounds the resident index,
    # autofaiss semantics)
    return IndexParams(
        kind="ivfpq", nlist=nlist, m=m, use_opq=d >= 64, use_refine=True
    )
