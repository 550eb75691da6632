"""Prompt emphasis and >77-token chunking (counterpart of sdxl_tpu/pipeline/prompt.py).

The host-side parsing and chunking is the reference's numpy code, copied:
the original cannot be imported without JAX (its package's __init__
imports it). ``apply_prompt_weights`` is the torch version.

  - attention syntax: (word) x1.1, ((word)) x1.21, (word:1.3), [word] /1.1,
    \\( \\) \\[ \\] literal brackets; per-token weights scale the encoded
    hidden states with a mean-norm correction;
  - long prompts spill into extra [SOT]...[EOT] chunks, encoded separately
    and concatenated along the token axis; the pooled embedding comes from
    the first chunk.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

_ATTN_RE = re.compile(
    r"""
    \\\(|\\\)|\\\[|\\\]|\\\\   # escaped bracket or backslash -> literal
    |\(                        # open round
    |\[                        # open square
    |:\s*([+-]?[\d.]+)\s*\)    # ":1.3)" explicit-weight close
    |\)                        # close round
    |\]                        # close square
    |[^\\()\[\]:]+             # plain text
    |:                         # stray colon -> literal
    """,
    re.VERBOSE,
)

ROUND_MULT = 1.1
SQUARE_MULT = 1.0 / 1.1


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    """Parse emphasis markup into [(fragment, weight)].

    Unbalanced brackets are tolerated (left open = applied to the end of
    the prompt). Adjacent fragments with equal weight are merged.
    """
    res: List[List] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def multiply_range(start: int, mult: float):
        for i in range(start, len(res)):
            res[i][1] *= mult

    for m in _ATTN_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None and round_stack:
            multiply_range(round_stack.pop(), float(weight))
        elif tok == ")" and round_stack:
            multiply_range(round_stack.pop(), ROUND_MULT)
        elif tok == "]" and square_stack:
            multiply_range(square_stack.pop(), SQUARE_MULT)
        else:
            res.append([tok, 1.0])

    for pos in round_stack:
        multiply_range(pos, ROUND_MULT)
    for pos in square_stack:
        multiply_range(pos, SQUARE_MULT)

    if not res:
        return [("", 1.0)]
    # merge equal-weight neighbors so BPE sees contiguous text
    merged: List[List] = [res[0]]
    for frag, w in res[1:]:
        if w == merged[-1][1]:
            merged[-1][0] += frag
        else:
            merged.append([frag, w])
    return [(f, w) for f, w in merged]


def encode_weighted_chunks(
    text: str,
    tokenizer,
    n_ctx: int = 77,
    max_chunks: int = 4,
    parse_attention: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a prompt into [n_chunks, n_ctx] ids + per-token weights.

    With a single chunk and no emphasis markup the ids row equals
    tokenize_text(text) exactly (same SOT/EOT/padding — reference parity,
    tokenizer/bpe.py:282-291); >75-content-token prompts spill into extra
    chunks instead of truncating, capped at max_chunks (the tail beyond
    the cap is dropped with the same truncation semantics as the
    reference).
    """
    if parse_attention:
        fragments = parse_prompt_attention(text)
    else:
        fragments = [(text, 1.0)]

    toks: List[int] = []
    wts: List[float] = []
    for frag, w in fragments:
        ids = tokenizer.encode(frag, add_sot=False, add_eot=False)
        toks.extend(ids)
        wts.extend([w] * len(ids))

    content = n_ctx - 2
    n_chunks = max(1, -(-len(toks) // content)) if toks else 1
    n_chunks = min(n_chunks, max_chunks)

    ids_out = np.full((n_chunks, n_ctx), tokenizer.pad_token, dtype=np.int32)
    w_out = np.ones((n_chunks, n_ctx), dtype=np.float32)
    for c in range(n_chunks):
        part = toks[c * content:(c + 1) * content]
        wpart = wts[c * content:(c + 1) * content]
        row = [tokenizer.sot_token] + part + [tokenizer.eot_token]
        ids_out[c, : len(row)] = row
        w_out[c, 1 : 1 + len(wpart)] = wpart
    return ids_out, w_out


def pad_chunks(ids: np.ndarray, weights: np.ndarray, n_chunks: int,
               tokenizer, n_ctx: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad a prompt's chunk list with empty-prompt chunks so every
    prompt in a batch (and the unconditional branch) has the same length."""
    have = ids.shape[0]
    if have >= n_chunks:
        return ids[:n_chunks], weights[:n_chunks]
    empty_ids, empty_w = encode_weighted_chunks(
        "", tokenizer, n_ctx, parse_attention=False
    )
    reps = n_chunks - have
    return (
        np.concatenate([ids] + [empty_ids] * reps, axis=0),
        np.concatenate([weights] + [empty_w] * reps, axis=0),
    )


def apply_prompt_weights(hidden: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Scale per-token hidden states [B, T, C] by their weights [B, T],
    keeping each row's mean absolute embedding (the A1111/compel
    convention)."""
    w = weights[..., None].to(hidden.dtype)
    scaled = hidden * w
    prev_mean = hidden.abs().mean(dim=(-2, -1), keepdim=True)
    new_mean = scaled.abs().mean(dim=(-2, -1), keepdim=True)
    return scaled * (prev_mean / new_mean.clamp(min=1e-12))


def batch_weighted_tokens(prompts, negative_prompt, tokenizer, n_ctx=77,
                          max_chunks=4, parse_attention=True):
    """Host-side batch prep shared by the SDXL and SD1 conditioning paths.

    Returns (ids [B,k,n_ctx], weights [B,k,n_ctx], uncond_ids [1,k,n_ctx],
    uncond_weights [1,k,n_ctx], weighted: bool, k) with every prompt and
    the unconditional branch padded to the same chunk count k.
    """
    enc = [encode_weighted_chunks(p, tokenizer, n_ctx, max_chunks,
                                  parse_attention) for p in prompts]
    u_ids, u_w = encode_weighted_chunks(negative_prompt, tokenizer, n_ctx,
                                        max_chunks, parse_attention)
    k = max([i.shape[0] for i, _ in enc] + [u_ids.shape[0]])
    ids = np.stack([pad_chunks(i, w, k, tokenizer, n_ctx)[0] for i, w in enc])
    wts = np.stack([pad_chunks(i, w, k, tokenizer, n_ctx)[1] for i, w in enc])
    u_ids, u_w = pad_chunks(u_ids, u_w, k, tokenizer, n_ctx)
    weighted = not (np.all(wts == 1.0) and np.all(u_w == 1.0))
    return (ids.astype(np.int32), wts.astype(np.float32),
            u_ids[None].astype(np.int32), u_w[None].astype(np.float32),
            weighted, k)
