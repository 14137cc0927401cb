"""Seeded captions: pseudo-words of lowercase ASCII letters.

Which word a caption holds is a counter-based hash of (seed, row, slot), so
the caption of any row can be worked out again on its own, in bulk or one
at a time, and both the data written for the program and the reference's
check use the same function.  Caption lengths are not drawn freely: every
seed gets the same multiset of lengths (fixed quantiles of the traffic
file's distribution) in another order, so the work does not change with
the seed."""

from __future__ import annotations

import functools
import math

import numpy as np

_ONSETS = ["b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p", "r", "s", "t", "v", "w", "z", "st", "tr", "ch"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ea", "ou"]
_CODAS = ["", "n", "r", "s", "t", "l", "m", "nd"]

_M64 = (1 << 64) - 1


@functools.cache
def vocabulary() -> tuple[str, ...]:
    """2,560 pseudo-words of one or two syllables (3 to 9 letters)."""
    one = [o + v + c for o in _ONSETS for v in _VOWELS for c in _CODAS]  # 1,280
    two = [one[i] + one[(i * 7 + 3) % len(one)][:3] for i in range(len(one))]
    return tuple(one + two)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finaliser over uint64 arrays."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_M64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_M64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_M64)
    return x ^ (x >> np.uint64(31))


def word_ids(seed: int, rows: np.ndarray, slots: int, n_words: int) -> np.ndarray:
    """(len(rows), slots) word indices in [0, n_words) for `rows`."""
    with np.errstate(over="ignore"):
        base = _mix(np.uint64(seed & _M64) + np.asarray(rows, np.uint64) * np.uint64(0x100000001B3))
        h = _mix(base[:, None] ^ (np.arange(1, slots + 1, dtype=np.uint64)[None, :] * np.uint64(0xD6E8FEB86659FD93)))
    return (h % np.uint64(n_words)).astype(np.int64)


def lengths(seed: int, n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n word counts: the lognormal(median, sigma) quantiles at (i + 1/2)/n,
    clipped to [lo, hi], in an order drawn from `seed`."""
    from statistics import NormalDist

    nd = NormalDist()
    q = np.array([median * math.exp(sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)])
    out = np.clip(np.rint(q), lo, hi).astype(np.int64)
    return out[np.random.default_rng(seed).permutation(n)]


def captions(seed: int, rows: np.ndarray, counts: np.ndarray) -> list[str]:
    """Caption of each row: counts[i] words."""
    vocab = vocabulary()
    ids = word_ids(seed, rows, int(counts.max()), len(vocab))
    return [" ".join(vocab[w] for w in ids[i, : counts[i]]) for i in range(len(rows))]


def index_caption(seed: int, row: int) -> str:
    """The metadata caption of stored row `row` of a generated index: three
    words and the row number (what `index_captions` writes)."""
    vocab = vocabulary()
    w = word_ids(seed, np.array([row]), 3, len(vocab))[0]
    return f"{vocab[w[0]]} {vocab[w[1]]} {vocab[w[2]]} {row}"


def index_captions(seed: int, n: int):
    """The `caption` column of a generated index as a pyarrow array, built
    in blocks (the same strings as `index_caption`)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    vocab = pa.array(vocabulary())
    parts = []
    block = 1 << 21
    for a in range(0, n, block):
        rows = np.arange(a, min(a + block, n))
        w = word_ids(seed, rows, 3, len(vocab))
        cols = [pc.take(vocab, pa.array(w[:, j])) for j in range(3)]
        parts.append(pc.binary_join_element_wise(*cols, pc.cast(pa.array(rows), pa.string()), " "))
    return pa.chunked_array(parts)
