"""CLIP text transformer, both SDXL towers and SD 1.x / 2.x's one
(counterpart of sdxl_tpu/models/clip.py).

Token + learned position embedding, pre-LN causal residual blocks,
quick_gelu (OpenAI CLIP) or exact gelu (OpenCLIP). ``clip_hidden`` taps the
raw hidden state after ``hidden_idx`` blocks (the penultimate-layer
trick); ``clip_final_hidden`` runs the whole tower and its final
LayerNorm (SD 1.x's conditioning); ``clip_hidden_pooled`` also returns
the final-LN embedding at the EOT position (the highest token id, ids >=
n_vocab masked) through ``text_projection``. Runs in float32;
activations are [B, T, C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import CLIPConfig
from ..ops.attention import causal_mask, qkv_attention
from .layers import LayerNorm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, s: int, **kw):
        super().__init__()
        self.q, self.k, self.v, self.out = (nn.Linear(s, s, **kw)
                                            for _ in range(4))

    def forward(self, x, mask, n_head):
        return self.out(qkv_attention(self.q(x), self.k(x), self.v(x), mask,
                                      n_head))


class CLIPMLP(nn.Module):
    def __init__(self, s: int, quick: bool, **kw):
        super().__init__()
        self.quick = quick
        self.fc1 = nn.Linear(s, 4 * s, **kw)
        self.fc2 = nn.Linear(4 * s, s, **kw)

    def forward(self, x):
        h = self.fc1(x)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return self.fc2(h)


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        s = cfg.n_state
        self.n_head = cfg.n_head
        self.attn = CLIPAttention(s, **kw)
        self.attn_ln = LayerNorm(s, **kw)
        self.mlp = CLIPMLP(s, cfg.quick_gelu, **kw)
        self.mlp_ln = LayerNorm(s, **kw)

    def forward(self, x, mask):
        x = x + self.attn(self.attn_ln(x), mask, self.n_head)
        return x + self.mlp(self.mlp_ln(x))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        s = cfg.n_state
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.n_vocab, s, **kw))
        self.position_embedding = nn.Parameter(torch.empty(cfg.n_ctx, s, **kw))
        self.blocks = nn.ModuleList(CLIPBlock(cfg, **kw)
                                    for _ in range(cfg.n_layer))
        self.layer_norm = LayerNorm(s, **kw)
        self.text_projection = nn.Parameter(
            torch.empty(s, cfg.embed_dim, **kw))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return (self.token_embedding[tokens]
                + self.position_embedding[: tokens.shape[1]][None])


def clip_hidden(model: CLIPTextModel, tokens: torch.Tensor,
                hidden_idx: int) -> torch.Tensor:
    """Hidden state after ``hidden_idx`` blocks, no final LN."""
    mask = causal_mask(tokens.shape[1], tokens.device)
    x = model.embed(tokens)
    for block in model.blocks[:hidden_idx]:
        x = block(x, mask)
    return x


def clip_final_hidden(model: CLIPTextModel,
                      tokens: torch.Tensor) -> torch.Tensor:
    """The whole tower and its final LayerNorm: SD 1.x's conditioning
    (diffusers' text_encoder last_hidden_state)."""
    return model.layer_norm(clip_hidden(model, tokens, len(model.blocks)))


def clip_hidden_pooled(model: CLIPTextModel, tokens: torch.Tensor,
                       hidden_idx: int, project: bool = True):
    """(hidden after ``hidden_idx`` blocks, pooled EOT embedding through
    text_projection). project=False, or a tower without a projection,
    returns the pooled embedding unprojected (FLUX.1 conditions on
    CLIPTextModel's raw pooler_output)."""
    mask = causal_mask(tokens.shape[1], tokens.device)
    x = model.embed(tokens)
    h_out = x
    for i, block in enumerate(model.blocks):
        if i == hidden_idx:
            h_out = x
        x = block(x, mask)
    pool_ids = torch.where(tokens < model.cfg.n_vocab, tokens, -1)
    eot_idx = torch.argmax(pool_ids, dim=1)
    normed = model.layer_norm(x)
    pooled = normed[torch.arange(tokens.shape[0], device=tokens.device),
                    eot_idx]
    if project and model.text_projection is not None:
        pooled = pooled @ model.text_projection
    return h_out, pooled
