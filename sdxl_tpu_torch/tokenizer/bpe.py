"""CLIP / OpenCLIP byte-pair-encoding tokenizers (the port's copy of
sdxl_tpu/tokenizer/bpe.py).

Host-side and framework-free. Both tokenizers share one merge table,
``data/bpe_merges.txt.gz`` (48894 merges, the public OpenAI CLIP BPE
vocabulary), from which the 49408-entry vocab derives: 256 byte-chars,
their ``</w>`` variants, the merges, then <|startoftext|> and
<|endoftext|>. Text is trimmed, whitespace-collapsed and lowercased, split
by the CLIP pre-tokenizer regex, and each piece merged greedily by lowest
rank. CLIP pads with EOT and maps the two special tokens to themselves;
OpenCLIP pads with 0.

An external tokenizer data directory (``data_dir``, else
$SDXL_TPU_TOKENIZER_DIR, else ./tokenizer) replaces the vendored table
when it exists, as in the reference. Textual-inversion trigger words
register pseudo-token ids above the vocab (``register_custom_token``).
The native merge core and decoding are not kept.
"""

from __future__ import annotations

import functools
import gzip
import os
import re as _std_re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import regex as re

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|\p{L}+|\p{N}"
    r"|[^\s\p{L}\p{N}]+",
    re.IGNORECASE,
)

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
MERGES_PATH = Path(__file__).resolve().parent / "data" / "bpe_merges.txt.gz"
N_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a printable unicode char (the GPT-2 / CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


@functools.lru_cache(maxsize=1)
def vendored_merges() -> Tuple[Tuple[str, str], ...]:
    """The merge table both tokenizers share."""
    with gzip.open(MERGES_PATH, "rt", encoding="utf-8") as f:
        merges = tuple((w[0], w[1]) for w in (line.split() for line in f)
                       if len(w) >= 2)
    if len(merges) != N_MERGES:
        raise ValueError(f"merge table corrupt: {len(merges)} entries, "
                         f"expected {N_MERGES}")
    return merges


def _load_merge_lines(path: str) -> List[Tuple[str, str]]:
    merges = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            words = line.split()
            if len(words) >= 2:
                merges.append((words[0], words[1]))
    return merges


def _resolve_data_dir(data_dir: Optional[str]) -> Optional[str]:
    """An external tokenizer data directory, if one is configured.

    Search order: explicit arg, $SDXL_TPU_TOKENIZER_DIR, ./tokenizer.
    Returns None when no external dir exists — callers then fall back to
    the vendored in-package table.
    """
    candidates = []
    if data_dir:
        candidates.append(data_dir)
    env = os.environ.get("SDXL_TPU_TOKENIZER_DIR")
    if env:
        candidates.append(env)
    candidates.append(os.path.join(os.getcwd(), "tokenizer"))
    for c in candidates:
        if os.path.isdir(c):
            return c
    if data_dir or env:
        raise FileNotFoundError(
            f"tokenizer data dir not found (searched: {candidates})"
        )
    return None


def derive_vocab(merges: Sequence[Tuple[str, str]]) -> List[str]:
    """The 49408-entry vocab of a merge table."""
    chars = list(bytes_to_unicode().values())
    return (chars + [c + "</w>" for c in chars] + [a + b for a, b in merges]
            + [SOT_TEXT, EOT_TEXT])


class Tokenizer:
    """Shared BPE machinery; subclasses set the padding token and whether
    the special tokens are pre-cached."""

    sot_token = 49406
    eot_token = 49407
    pad_token = 49407

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 vocab: Sequence[str], cache_specials: bool):
        self.byte_encoder = bytes_to_unicode()
        self.encoder: Dict[str, int] = {w: i for i, w in enumerate(vocab)}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges)}
        self._cache: Dict[str, str] = (
            {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT} if cache_specials else {})
        # textual-inversion trigger words -> pseudo-token id lists; ids live
        # above the vocab (>= len(encoder)) and index appended embedding rows
        self._custom: Dict[str, List[int]] = {}
        self._custom_re = None

    def register_custom_token(self, word: str, n_vectors: int) -> List[int]:
        """Register a textual-inversion trigger word mapping to n_vectors
        consecutive pseudo-token ids (allocated above the base vocab, in
        registration order). Returns the ids. Idempotent per word."""
        key = _whitespace_clean(word.strip()).lower()
        if not key:
            raise ValueError("empty textual-inversion trigger word")
        if key in self._custom:
            return self._custom[key]
        next_id = len(self.encoder) + sum(len(v) for v in self._custom.values())
        ids = list(range(next_id, next_id + int(n_vectors)))
        self._custom[key] = ids
        pat = "|".join(_std_re.escape(w)
                       for w in sorted(self._custom, key=len, reverse=True))
        # match only at word boundaries of the cleaned lowercase text
        self._custom_re = _std_re.compile(rf"(?<!\w)(?:{pat})(?!\w)")
        return ids

    def bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token)
        if word:
            word[-1] = word[-1] + "</w>"
        if len(word) < 2:
            return token + "</w>"

        while True:
            pairs = set(zip(word[:-1], word[1:]))
            ranked = [p for p in pairs if p in self.bpe_ranks]
            if not ranked:
                break
            first, second = min(ranked, key=lambda p: self.bpe_ranks[p])
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
            if len(word) == 1:
                break

        out = " ".join(word)
        self._cache[token] = out
        return out

    def _encode_fragment(self, fragment: str, out: List[int]) -> None:
        enc = self.byte_encoder
        for m in _PAT.finditer(fragment):
            mapped = "".join(enc[b] for b in m.group(0).encode("utf-8"))
            out.extend(self.encoder[piece]
                       for piece in self.bpe(mapped).split(" "))

    def encode(self, text: str, add_sot: bool = True,
               add_eot: bool = True) -> List[int]:
        cleaned = _whitespace_clean(text.strip()).lower()
        tokens: List[int] = [self.sot_token] if add_sot else []
        if self._custom_re is None:
            self._encode_fragment(cleaned, tokens)
        else:
            pos = 0
            for m in self._custom_re.finditer(cleaned):
                self._encode_fragment(cleaned[pos:m.start()], tokens)
                tokens.extend(self._custom[m.group(0)])
                pos = m.end()
            self._encode_fragment(cleaned[pos:], tokens)
        if add_eot:
            tokens.append(self.eot_token)
        return tokens


class ClipTokenizer(Tokenizer):
    """OpenAI-CLIP tokenizer (ViT-L text tower); pad = EOT."""

    pad_token = 49407

    def __init__(self, data_dir: Optional[str] = None):
        root = _resolve_data_dir(data_dir)
        path = (os.path.join(root, "clip", "bpe_simple_vocab_16e6.txt")
                if root is not None else None)
        if path is not None and os.path.isfile(path):
            # the header line and the tail beyond the vocab budget are cut,
            # merges[1 .. 49152-256-2+1] (clip.rs:98)
            merges = _load_merge_lines(path)[1: N_MERGES + 1]
        else:
            merges = vendored_merges()
        super().__init__(merges, derive_vocab(merges), cache_specials=True)


class OpenClipTokenizer(Tokenizer):
    """OpenCLIP (ViT-bigG text tower) tokenizer; pad = 0."""

    pad_token = 0

    def __init__(self, data_dir: Optional[str] = None):
        root = _resolve_data_dir(data_dir)
        path = (os.path.join(root, "open_clip", "merges.txt")
                if root is not None else None)
        if path is not None and os.path.isfile(path):
            merges = _load_merge_lines(path)
            with open(os.path.join(root, "open_clip", "vocab.txt"), "r",
                      encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f]
        else:
            merges = vendored_merges()
            vocab = derive_vocab(merges)
        super().__init__(merges, vocab, cache_specials=False)
