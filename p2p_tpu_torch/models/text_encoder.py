"""Text encoders — the PyTorch counterpart of
``p2p_tpu/models/text_encoder.py``: the causal CLIP towers (SD-1.4's
quick_gelu one, SD-2.1's 23 layers of 1024 with exact gelu) and LDM-256's
non-causal LDMBert (32 layers of 1280, 8 heads of 64 without q/k/v bias,
gelu). One config-driven pre-norm transformer covers them; the weights'
names follow the config's ``arch`` (``checkpoint.encoder_entries``).

``ids (B, L) -> (B, L, D)`` final-layer hidden states after the final
LayerNorm. CLIP's causal mask is additive (-1e9 above the diagonal), so its
attention takes the materialized einsum; LDMBert's 77 positions are under
the flash kernel's threshold, so its does too.
"""

from __future__ import annotations

import functools

import torch

from . import nn
from .checkpoint import StateDict, encoder_entries
from .config import TextEncoderConfig


@functools.lru_cache(maxsize=None)
def _names(cfg: TextEncoderConfig):
    """The state-dict name of each JAX parameter path
    (``("layers", i, "q", "kernel")`` → ``...q_proj.weight``)."""
    return {path: name for path, name, _ in encoder_entries(cfg)}


def apply_text_encoder(sd: StateDict, cfg: TextEncoderConfig,
                       ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``ids (B, L) -> (B, L, D)`` in ``dtype``; ``sd``'s linear and
    embedding weights in ``dtype`` (``engine.sampler.Pipeline.weights``)."""
    names = _names(cfg)
    b, length = ids.shape
    x = nn.add(sd[names[("token_embed",)]][ids].to(dtype),
               sd[names[("pos_embed",)]][:length].to(dtype))

    mask = None
    if cfg.causal:
        mask = torch.triu(torch.full((length, length), -1e9, dtype=torch.float32,
                                     device=ids.device), diagonal=1)[None, None]

    heads = cfg.num_heads
    d_head = cfg.inner_dim // heads
    scale = d_head ** -0.5
    act = nn.quick_gelu if cfg.activation == "quick_gelu" else nn.gelu

    def split_heads(t):
        return t.reshape(b, length, heads, d_head).transpose(1, 2)

    def norm(path, t):
        return nn.layer_norm(t, sd[names[path + ("scale",)]],
                             sd[names[path + ("bias",)]])

    def lin(path, t):
        bias = names.get(path + ("bias",))
        return nn.linear(t, sd[names[path + ("kernel",)]],
                         None if bias is None else sd[bias])

    for i in range(cfg.num_layers):
        layer = ("layers", i)
        h = norm(layer + ("ln1",), x)
        q = split_heads(lin(layer + ("q",), h))
        k = split_heads(lin(layer + ("k",), h))
        v = split_heads(lin(layer + ("v",), h))
        attn = nn.fused_attention(q, k, v, scale, mask)
        attn = attn.transpose(1, 2).reshape(b, length, cfg.inner_dim)
        x = nn.add(x, lin(layer + ("out",), attn))

        h = norm(layer + ("ln2",), x)
        x = nn.add(x, lin(layer + ("fc2",), act(lin(layer + ("fc1",), h))))

    return norm(("final_ln",), x)
