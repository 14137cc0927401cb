"""CLIP byte-pair-encoding tokenizer (pure Python, perf-uncritical).

The reference gets its tokenizer from `all_clip.load_clip`
(rom1504/clip-retrieval `clip_retrieval/clip_inference/mapper.py:36`, used at
`reader.py:109,172` and `clip_back.py:223`).  This is a first-party
implementation of the same algorithm (byte→unicode table, `</w>` word-end
markers, ranked merges, sot/eot specials) that reproduces openai CLIP
tokenization exactly when pointed at the standard
`bpe_simple_vocab_16e6.txt.gz` merges file.

Tokenization happens on host; batches of int32 ids ship to device.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

try:  # `regex` supports \p{L}/\p{N}; stdlib `re` does not.
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Invertible byte → printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Sequence[str]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    # openai CLIP cleans with ftfy.fix_text (which NFC-normalizes) + double
    # html.unescape + whitespace collapse; NFC here keeps decomposed
    # Unicode (e.g. 'e'+U+0301) tokenizing identically to the composed form
    # and identically across the python and rust paths
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def default_bpe_path() -> str | None:
    """Locate the standard merges file if present (no network in this env)."""
    candidates = [
        os.environ.get("CRT_BPE_PATH"),
        os.path.expanduser(
            "~/.cache/clip_retrieval_tpu/bpe_simple_vocab_16e6.txt.gz"
        ),
        os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class CLIPTokenizer:
    """BPE tokenizer. Construct from a merges file or an explicit merge list.

    With `merges=[]` this degrades to a pure byte-level tokenizer — used by
    tests and available as a dependency-free fallback (`byte_fallback=True`).
    """

    def __init__(
        self,
        bpe_path: str | None = None,
        merges: List[tuple[str, str]] | None = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            if bpe_path is None:
                bpe_path = default_bpe_path()
            if bpe_path is None:
                raise FileNotFoundError(
                    "no BPE merges file found; set CRT_BPE_PATH or pass "
                    "merges= (use CLIPTokenizer.byte_fallback() for a "
                    "vocab-free tokenizer)"
                )
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard file: line 0 is a header, merges are 1..49152-256-2+1
            merges = [
                tuple(line.split())
                for line in lines[1 : 49152 - 256 - 2 + 1]
                if len(line.split()) == 2
            ]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]
        self.vocab_size = len(vocab)
        self._cache: dict[str, str] = {SOT: SOT, EOT: EOT}
        # rust-backed fast path (GIL-free, parallel encode_batch) when the
        # `tokenizers` library is available; parity-tested vs the pure
        # python BPE (html-unescape happens python-side in _clean)
        self._fast = None
        if os.environ.get("CRT_DISABLE_FAST_TOKENIZER") != "1":
            try:
                self._fast = self._build_fast(merges)
            except Exception:
                self._fast = None

    def _build_fast(self, merges):
        from tokenizers import (
            Regex,
            Tokenizer,
            models as tk_models,
            normalizers,
            pre_tokenizers,
        )

        tok = Tokenizer(
            tk_models.BPE(
                vocab=dict(self.encoder),
                merges=[tuple(m) for m in merges],
                end_of_word_suffix="</w>",
                fuse_unk=False,
                unk_token=None,
            )
        )
        tok.normalizer = normalizers.Sequence(
            [normalizers.NFC(), normalizers.Lowercase()]
        )
        tok.pre_tokenizer = pre_tokenizers.Sequence(
            [
                pre_tokenizers.Split(
                    Regex(_PAT.pattern), behavior="removed", invert=True
                ),
                pre_tokenizers.ByteLevel(
                    add_prefix_space=False, use_regex=False
                ),
            ]
        )
        # literal '<|startoftext|>'/'<|endoftext|>' in input text must map
        # to the single special ids like the python path's _cache does
        # (reusing the existing vocab ids), not be BPE-split into subwords
        from tokenizers import AddedToken

        tok.add_special_tokens(
            [AddedToken(SOT, normalized=False), AddedToken(EOT, normalized=False)]
        )
        return tok

    @classmethod
    def byte_fallback(cls) -> "CLIPTokenizer":
        return cls(merges=[])

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return (
            bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(
        self, texts: str | Sequence[str], context_length: int = 77
    ) -> np.ndarray:
        """Tokenize → (B, context_length) int32, sot/eot framed, 0-padded.

        Over-long inputs are truncated with eot preserved in the last slot
        (same behavior as open_clip's tokenize(truncate=True)).
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        if self._fast is not None:
            encs = self._fast.encode_batch([_clean(t) for t in texts])
            all_ids = [e.ids for e in encs]
        else:
            all_ids = [self.encode(t) for t in texts]
        for row, body in enumerate(all_ids):
            ids = [self.sot_token] + list(body) + [self.eot_token]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot_token
            out[row, : len(ids)] = ids
        return out


class SiglipTokenizer:
    """SigLIP's framing of a caption (open_clip's `ViT-SO400M-14-SigLIP-384`
    tokenizer): no start token, EOS (id 1) appended, padded with the pad id
    (also 1) to `context_length`, over-long input cut with EOS kept last.

    The published tokenizer is a SentencePiece model that is not in this
    repository, so the ids are byte-level: UTF-8 byte b is id 3 + b (ids 0-2
    are SentencePiece's pad/eos/unk).  A trained checkpoint's text tower
    reads these ids as other tokens than it was trained on."""

    PAD = EOS = 1
    OFFSET = 3
    vocab_size = OFFSET + 256

    def encode(self, text: str) -> List[int]:
        return [self.OFFSET + b for b in text.encode("utf-8")]

    def __call__(self, texts: str | Sequence[str], context_length: int = 64) -> np.ndarray:
        """Tokenize → (B, context_length) int32, EOS framed, pad-filled."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.PAD, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: context_length - 1] + [self.EOS]
            out[row, : len(ids)] = ids
        return out
