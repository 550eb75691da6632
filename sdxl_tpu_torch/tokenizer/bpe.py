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

Only the vendored table and the pure-Python merge loop are kept: no
external tokenizer directory, no native merge core, no textual-inversion
pseudo-tokens, no decoding.
"""

from __future__ import annotations

import functools
import gzip
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

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

    def __init__(self, cache_specials: bool):
        merges = vendored_merges()
        self.byte_encoder = bytes_to_unicode()
        self.encoder: Dict[str, int] = {
            w: i for i, w in enumerate(derive_vocab(merges))}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges)}
        self._cache: Dict[str, str] = (
            {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT} if cache_specials else {})

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

    def encode(self, text: str, add_sot: bool = True,
               add_eot: bool = True) -> List[int]:
        cleaned = _whitespace_clean(text.strip()).lower()
        tokens: List[int] = [self.sot_token] if add_sot else []
        enc = self.byte_encoder
        for m in _PAT.finditer(cleaned):
            mapped = "".join(enc[b] for b in m.group(0).encode("utf-8"))
            tokens.extend(self.encoder[piece]
                          for piece in self.bpe(mapped).split(" "))
        if add_eot:
            tokens.append(self.eot_token)
        return tokens


class ClipTokenizer(Tokenizer):
    """OpenAI-CLIP tokenizer (ViT-L text tower); pad = EOT."""

    pad_token = 49407

    def __init__(self):
        super().__init__(cache_specials=True)


class OpenClipTokenizer(Tokenizer):
    """OpenCLIP (ViT-bigG text tower) tokenizer; pad = 0."""

    pad_token = 0

    def __init__(self):
        super().__init__(cache_specials=False)
