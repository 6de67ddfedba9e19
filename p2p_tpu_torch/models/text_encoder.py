"""CLIP text encoder — the PyTorch counterpart of
``p2p_tpu/models/text_encoder.py`` for the causal CLIP towers: SD-1.4's
(quick_gelu) and SD-2.1's (23 layers of 1024, exact gelu).

``ids (B, L) -> (B, L, D)`` final-layer hidden states after the final
LayerNorm. The causal mask is additive (-1e9 above the diagonal), so its
attention takes the materialized einsum, never the flash kernel.
"""

from __future__ import annotations

import torch

from . import nn
from .checkpoint import StateDict
from .config import TextEncoderConfig


def apply_text_encoder(sd: StateDict, cfg: TextEncoderConfig,
                       ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``ids (B, L) -> (B, L, D)`` in ``dtype``; ``sd``'s linear and
    embedding weights in ``dtype`` (``engine.sampler.Pipeline.weights``)."""
    if cfg.arch != "clip":
        raise NotImplementedError(f"text encoder arch {cfg.arch!r} is not "
                                  "ported to p2p_tpu_torch")
    b, length = ids.shape
    x = nn.add(sd["text_model.embeddings.token_embedding.weight"][ids].to(dtype),
               sd["text_model.embeddings.position_embedding.weight"][:length].to(dtype))

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

    for i in range(cfg.num_layers):
        p = f"text_model.encoder.layers.{i}."

        def lin(name, t):
            return nn.linear(t, sd[p + name + ".weight"], sd.get(p + name + ".bias"))

        h = nn.layer_norm(x, sd[p + "layer_norm1.weight"], sd[p + "layer_norm1.bias"])
        q = split_heads(lin("self_attn.q_proj", h))
        k = split_heads(lin("self_attn.k_proj", h))
        v = split_heads(lin("self_attn.v_proj", h))
        attn = nn.fused_attention(q, k, v, scale, mask)
        attn = attn.transpose(1, 2).reshape(b, length, cfg.inner_dim)
        x = nn.add(x, lin("self_attn.out_proj", attn))

        h = nn.layer_norm(x, sd[p + "layer_norm2.weight"], sd[p + "layer_norm2.bias"])
        x = nn.add(x, lin("mlp.fc2", act(lin("mlp.fc1", h))))

    return nn.layer_norm(x, sd["text_model.final_layer_norm.weight"],
                         sd["text_model.final_layer_norm.bias"])
