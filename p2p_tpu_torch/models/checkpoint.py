"""Weights: diffusers names, JAX parameter trees, files and random init.

The port's models read their weights from a flat state dict keyed by the
diffusers names (``down_blocks.0.resnets.0.conv1.weight``) in torch layouts
(Linear ``(out, in)``, Conv ``(O, I, kH, kW)``). This module holds:

- the name tables ``unet_entries`` / ``text_encoder_entries`` /
  ``ldm_text_encoder_entries`` / ``vae_entries``: a jax-free copy of
  ``p2p_tpu/models/checkpoint.py``'s (``encoder_entries`` picks the text
  encoder's by its ``arch``),
  mapping each JAX parameter-tree path to its diffusers name and layout
  transform (``tests/test_torch_copies.py`` holds them equal);
- :func:`from_jax_params`, which turns a JAX parameter pytree (nested
  dicts/lists of numpy arrays) into the port's state dict;
- loaders of diffusers checkpoint files (:func:`load_unet`, ...);
- ``init_*``: random weights with the JAX package's scheme
  (``U(±1/√fan_in)`` weights, zero biases, unit norm scales) from a seed,
  made on the target device.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import TextEncoderConfig, UNetConfig, VAEConfig

# A mapping entry: (jax_path, diffusers_name, kind) where kind selects the
# layout transform: 'linear' | 'conv' | 'none'.
Entry = Tuple[Tuple[Any, ...], str, str]

StateDict = Dict[str, torch.Tensor]


def _lin(our_prefix, their_prefix, bias=True) -> List[Entry]:
    out = [(our_prefix + ("kernel",), their_prefix + ".weight", "linear")]
    if bias:
        out.append((our_prefix + ("bias",), their_prefix + ".bias", "none"))
    return out


def _conv(our_prefix, their_prefix) -> List[Entry]:
    return [(our_prefix + ("kernel",), their_prefix + ".weight", "conv"),
            (our_prefix + ("bias",), their_prefix + ".bias", "none")]


def _norm(our_prefix, their_prefix) -> List[Entry]:
    return [(our_prefix + ("scale",), their_prefix + ".weight", "none"),
            (our_prefix + ("bias",), their_prefix + ".bias", "none")]


def _resnet(our, their, has_skip: bool, time: bool = True) -> List[Entry]:
    e = (_norm(our + ("norm1",), their + ".norm1")
         + _conv(our + ("conv1",), their + ".conv1")
         + _norm(our + ("norm2",), their + ".norm2")
         + _conv(our + ("conv2",), their + ".conv2"))
    if time:
        e += _lin(our + ("time_proj",), their + ".time_emb_proj")
    if has_skip:
        e += _conv(our + ("skip",), their + ".conv_shortcut")
    return e


def _attn(our, their) -> List[Entry]:
    return (_lin(our + ("to_q",), their + ".to_q", bias=False)
            + _lin(our + ("to_k",), their + ".to_k", bias=False)
            + _lin(our + ("to_v",), their + ".to_v", bias=False)
            + _lin(our + ("to_out",), their + ".to_out.0"))


def _tblock(our, their) -> List[Entry]:
    return (_norm(our + ("ln1",), their + ".norm1")
            + _attn(our + ("attn1",), their + ".attn1")
            + _norm(our + ("ln2",), their + ".norm2")
            + _attn(our + ("attn2",), their + ".attn2")
            + _norm(our + ("ln3",), their + ".norm3")
            + _lin(our + ("ff_in",), their + ".ff.net.0.proj")
            + _lin(our + ("ff_out",), their + ".ff.net.2"))


def _spatial_transformer(our, their, depth: int) -> List[Entry]:
    e = (_norm(our + ("norm",), their + ".norm")
         + _conv(our + ("proj_in",), their + ".proj_in"))
    for d in range(depth):
        e += _tblock(our + ("blocks", d), their + f".transformer_blocks.{d}")
    e += _conv(our + ("proj_out",), their + ".proj_out")
    return e


def unet_entries(cfg: UNetConfig) -> List[Entry]:
    e: List[Entry] = []
    e += _lin(("time_fc1",), "time_embedding.linear_1")
    e += _lin(("time_fc2",), "time_embedding.linear_2")
    e += _conv(("conv_in",), "conv_in")

    n = cfg.levels
    ch = list(cfg.block_channels)
    in_ch = ch[0]
    skip_chs = [ch[0]]
    for lvl in range(n):
        out_ch = ch[lvl]
        for j in range(cfg.layers_per_block):
            e += _resnet(("down", lvl, "resnets", j),
                         f"down_blocks.{lvl}.resnets.{j}", has_skip=in_ch != out_ch)
            if cfg.attn_levels[lvl]:
                e += _spatial_transformer(("down", lvl, "attns", j),
                                          f"down_blocks.{lvl}.attentions.{j}",
                                          cfg.transformer_depth)
            in_ch = out_ch
            skip_chs.append(out_ch)
        if lvl != n - 1:
            e += _conv(("down", lvl, "downsample"),
                       f"down_blocks.{lvl}.downsamplers.0.conv")
            skip_chs.append(out_ch)

    e += _resnet(("mid", "resnet1"), "mid_block.resnets.0", has_skip=False)
    e += _spatial_transformer(("mid", "attn"), "mid_block.attentions.0",
                              cfg.transformer_depth)
    e += _resnet(("mid", "resnet2"), "mid_block.resnets.1", has_skip=False)

    in_ch = ch[-1]
    for pos, lvl in enumerate(reversed(range(n))):
        out_ch = ch[lvl]
        for j in range(cfg.layers_per_block + 1):
            skip_ch = skip_chs.pop()
            e += _resnet(("up", pos, "resnets", j),
                         f"up_blocks.{pos}.resnets.{j}",
                         has_skip=(in_ch + skip_ch) != out_ch)
            if cfg.attn_levels[lvl]:
                e += _spatial_transformer(("up", pos, "attns", j),
                                          f"up_blocks.{pos}.attentions.{j}",
                                          cfg.transformer_depth)
            in_ch = out_ch
        if lvl != 0:
            e += _conv(("up", pos, "upsample"),
                       f"up_blocks.{pos}.upsamplers.0.conv")

    e += _norm(("norm_out",), "conv_norm_out")
    e += _conv(("conv_out",), "conv_out")
    return e


def text_encoder_entries(cfg: TextEncoderConfig) -> List[Entry]:
    e: List[Entry] = [
        (("token_embed",), "text_model.embeddings.token_embedding.weight", "none"),
        (("pos_embed",), "text_model.embeddings.position_embedding.weight", "none"),
    ]
    for i in range(cfg.num_layers):
        base = f"text_model.encoder.layers.{i}"
        e += _norm(("layers", i, "ln1"), base + ".layer_norm1")
        e += _lin(("layers", i, "q"), base + ".self_attn.q_proj")
        e += _lin(("layers", i, "k"), base + ".self_attn.k_proj")
        e += _lin(("layers", i, "v"), base + ".self_attn.v_proj")
        e += _lin(("layers", i, "out"), base + ".self_attn.out_proj")
        e += _norm(("layers", i, "ln2"), base + ".layer_norm2")
        e += _lin(("layers", i, "fc1"), base + ".mlp.fc1")
        e += _lin(("layers", i, "fc2"), base + ".mlp.fc2")
    e += _norm(("final_ln",), "text_model.final_layer_norm")
    return e


def ldm_text_encoder_entries(cfg: TextEncoderConfig) -> List[Entry]:
    """diffusers ``LDMBertModel`` names: pre-norm encoder layers under
    ``model.layers.N``, learned position embeddings, final
    ``model.layer_norm``."""
    e: List[Entry] = [
        (("token_embed",), "model.embed_tokens.weight", "none"),
        (("pos_embed",), "model.embed_positions.weight", "none"),
    ]
    for i in range(cfg.num_layers):
        base = f"model.layers.{i}"
        e += _norm(("layers", i, "ln1"), base + ".self_attn_layer_norm")
        e += _lin(("layers", i, "q"), base + ".self_attn.q_proj",
                  bias=cfg.attn_qkv_bias)
        e += _lin(("layers", i, "k"), base + ".self_attn.k_proj",
                  bias=cfg.attn_qkv_bias)
        e += _lin(("layers", i, "v"), base + ".self_attn.v_proj",
                  bias=cfg.attn_qkv_bias)
        e += _lin(("layers", i, "out"), base + ".self_attn.out_proj")
        e += _norm(("layers", i, "ln2"), base + ".final_layer_norm")
        e += _lin(("layers", i, "fc1"), base + ".fc1")
        e += _lin(("layers", i, "fc2"), base + ".fc2")
    e += _norm(("final_ln",), "model.layer_norm")
    return e


def encoder_entries(cfg: TextEncoderConfig) -> List[Entry]:
    """The text encoder's name table for its ``arch``."""
    if cfg.arch == "ldmbert":
        return ldm_text_encoder_entries(cfg)
    if cfg.arch == "clip":
        return text_encoder_entries(cfg)
    raise ValueError(f"unknown text encoder arch: {cfg.arch!r}")


def _vae_attn(our, their) -> List[Entry]:
    return (_norm(our + ("norm",), their + ".group_norm")
            + _lin(our + ("q",), their + ".query")
            + _lin(our + ("k",), their + ".key")
            + _lin(our + ("v",), their + ".value")
            + _lin(our + ("out",), their + ".proj_attn"))


def vae_entries(cfg: VAEConfig) -> List[Entry]:
    e: List[Entry] = []
    chs = [cfg.base_channels * m for m in cfg.channel_mults]
    n = len(chs)

    e += _conv(("encoder", "conv_in"), "encoder.conv_in")
    in_ch = chs[0]
    for lvl in range(n):
        out_ch = chs[lvl]
        for j in range(cfg.layers_per_block):
            e += _resnet(("encoder", "down", lvl, "resnets", j),
                         f"encoder.down_blocks.{lvl}.resnets.{j}",
                         has_skip=in_ch != out_ch, time=False)
            in_ch = out_ch
        if lvl != n - 1:
            e += _conv(("encoder", "down", lvl, "downsample"),
                       f"encoder.down_blocks.{lvl}.downsamplers.0.conv")
    e += _resnet(("encoder", "mid", "resnet1"), "encoder.mid_block.resnets.0",
                 has_skip=False, time=False)
    e += _vae_attn(("encoder", "mid", "attn"), "encoder.mid_block.attentions.0")
    e += _resnet(("encoder", "mid", "resnet2"), "encoder.mid_block.resnets.1",
                 has_skip=False, time=False)
    e += _norm(("encoder", "norm_out"), "encoder.conv_norm_out")
    e += _conv(("encoder", "conv_out"), "encoder.conv_out")
    e += _conv(("encoder", "quant_conv"), "quant_conv")
    if cfg.kind == "vq":
        # diffusers VQModel keeps the codebook at quantize.embedding.
        e.append((("codebook",), "quantize.embedding.weight", "none"))

    e += _conv(("decoder", "post_quant_conv"), "post_quant_conv")
    e += _conv(("decoder", "conv_in"), "decoder.conv_in")
    e += _resnet(("decoder", "mid", "resnet1"), "decoder.mid_block.resnets.0",
                 has_skip=False, time=False)
    e += _vae_attn(("decoder", "mid", "attn"), "decoder.mid_block.attentions.0")
    e += _resnet(("decoder", "mid", "resnet2"), "decoder.mid_block.resnets.1",
                 has_skip=False, time=False)
    in_ch = chs[-1]
    for pos, lvl in enumerate(reversed(range(n))):
        out_ch = chs[lvl]
        for j in range(cfg.layers_per_block + 1):
            e += _resnet(("decoder", "up", pos, "resnets", j),
                         f"decoder.up_blocks.{pos}.resnets.{j}",
                         has_skip=in_ch != out_ch, time=False)
            in_ch = out_ch
        if lvl != 0:
            e += _conv(("decoder", "up", pos, "upsample"),
                       f"decoder.up_blocks.{pos}.upsamplers.0.conv")
    e += _norm(("decoder", "norm_out"), "decoder.conv_norm_out")
    e += _conv(("decoder", "conv_out"), "decoder.conv_out")
    return e


# ---------------------------------------------------------------------------
# Tree navigation + load/export
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# JAX parameter trees and checkpoint files
# ---------------------------------------------------------------------------

# JAX layout -> torch layout: Linear (in, out) -> (out, in); Conv HWIO -> OIHW.
_TO_TORCH = {"linear": lambda w: w.T,
             "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
             "none": lambda w: w}


def _get(tree: Any, path: Tuple[Any, ...]) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def from_jax_params(tree: Any, entries: List[Entry]) -> StateDict:
    """The port's state dict from a JAX parameter pytree (nested dicts and
    lists of numpy arrays): every entry's array under its diffusers name,
    transposed to the torch layout, as f32 CPU tensors."""
    return {name: torch.from_numpy(np.array(
                _TO_TORCH[kind](np.asarray(_get(tree, path), np.float32))))
            for path, name, kind in entries}


def norm_names(entries: List[Entry]) -> set:
    """The diffusers names of the norms' scales and biases in ``entries``
    (the entries whose JAX path ends in a ``scale`` leaf, and their
    siblings)."""
    norms = {path[:-1] for path, _, _ in entries if path[-1] == "scale"}
    return {name for path, name, _ in entries if path[:-1] in norms}


def read_state_dict(path: str) -> StateDict:
    """Read a torch ``.bin``/``.pt`` or ``.safetensors`` file (CPU tensors)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file  # optional dependency

        return dict(load_file(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def _find_weights_file(dirpath: str, names: Tuple[str, ...]) -> str:
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights file in {dirpath} (tried {names})")


def check_state_dict(sd: StateDict, expected: StateDict) -> None:
    """Raise unless ``sd`` has exactly the names of ``expected`` (position
    ids aside) with the same shapes."""
    missing = [k for k in expected if k not in sd]
    extra = [k for k in sd if k not in expected and not k.endswith("position_ids")]
    if missing or extra:
        raise KeyError(f"checkpoint: {len(missing)} missing (first "
                       f"{missing[:3]}), {len(extra)} unmapped (first {extra[:3]})")
    for k, want in expected.items():
        if tuple(sd[k].shape) != tuple(want.shape):
            raise ValueError(f"checkpoint: {k} has shape {tuple(sd[k].shape)}, "
                             f"the model needs {tuple(want.shape)}")


def _load(dirpath: str, files: Tuple[str, ...], expected: StateDict,
          device) -> StateDict:
    sd = read_state_dict(_find_weights_file(dirpath, files))
    check_state_dict(sd, expected)
    return {k: sd[k].to(device=device, dtype=torch.float32) for k in expected}


def load_unet(cfg: UNetConfig, dirpath: str, device) -> StateDict:
    return _load(dirpath, ("diffusion_pytorch_model.safetensors",
                           "diffusion_pytorch_model.bin"),
                 init_unet(cfg, None, "meta"), device)


def load_text_encoder(cfg: TextEncoderConfig, dirpath: str, device) -> StateDict:
    return _load(dirpath, ("model.safetensors", "pytorch_model.bin"),
                 init_text_encoder(cfg, None, "meta"), device)


def load_vae(cfg: VAEConfig, dirpath: str, device) -> StateDict:
    return _load(dirpath, ("diffusion_pytorch_model.safetensors",
                           "diffusion_pytorch_model.bin"),
                 init_vae(cfg, None, "meta"), device)


# ---------------------------------------------------------------------------
# Random init (the JAX package's scheme, torch's generator)
# ---------------------------------------------------------------------------


class _Maker:
    """Makes named parameters on ``device`` from one seeded generator;
    ``seed=None`` on the ``meta`` device gives shapes only."""

    def __init__(self, seed: Optional[int], device):
        self.device = torch.device(device)
        self.gen = (None if seed is None else
                    torch.Generator(self.device).manual_seed(seed))
        self.sd: StateDict = {}

    def _uniform(self, shape, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            s = 1.0 / math.sqrt(fan_in)
            w.uniform_(-s, s, generator=self.gen)
        return w

    def _const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=self.device)

    def linear(self, name: str, d_in: int, d_out: int, bias: bool = True):
        self.sd[name + ".weight"] = self._uniform((d_out, d_in), d_in)
        if bias:
            self.sd[name + ".bias"] = self._const((d_out,), 0.0)

    def conv(self, name: str, c_in: int, c_out: int, k: int = 3):
        self.sd[name + ".weight"] = self._uniform((c_out, c_in, k, k), c_in * k * k)
        self.sd[name + ".bias"] = self._const((c_out,), 0.0)

    def norm(self, name: str, dim: int):
        self.sd[name + ".weight"] = self._const((dim,), 1.0)
        self.sd[name + ".bias"] = self._const((dim,), 0.0)

    def normal(self, name: str, shape, std: float):
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            w.normal_(0.0, std, generator=self.gen)
        self.sd[name] = w

    def resnet(self, name: str, c_in: int, c_out: int, temb: Optional[int]):
        self.norm(name + ".norm1", c_in)
        self.conv(name + ".conv1", c_in, c_out)
        if temb is not None:
            self.linear(name + ".time_emb_proj", temb, c_out)
        self.norm(name + ".norm2", c_out)
        self.conv(name + ".conv2", c_out, c_out)
        if c_in != c_out:
            self.conv(name + ".conv_shortcut", c_in, c_out, k=1)


def _init_attn(m: _Maker, name: str, dim: int, context_dim: int):
    m.linear(name + ".to_q", dim, dim, bias=False)
    m.linear(name + ".to_k", context_dim, dim, bias=False)
    m.linear(name + ".to_v", context_dim, dim, bias=False)
    m.linear(name + ".to_out.0", dim, dim)


def _init_spatial_transformer(m: _Maker, name: str, ch: int, cfg: UNetConfig):
    m.norm(name + ".norm", ch)
    m.conv(name + ".proj_in", ch, ch, k=1)
    for d in range(cfg.transformer_depth):
        blk = f"{name}.transformer_blocks.{d}"
        m.norm(blk + ".norm1", ch)
        _init_attn(m, blk + ".attn1", ch, ch)
        m.norm(blk + ".norm2", ch)
        _init_attn(m, blk + ".attn2", ch, cfg.context_dim)
        m.norm(blk + ".norm3", ch)
        m.linear(blk + ".ff.net.0.proj", ch, ch * cfg.ff_mult * 2)
        m.linear(blk + ".ff.net.2", ch * cfg.ff_mult, ch)
    m.conv(name + ".proj_out", ch, ch, k=1)


def init_unet(cfg: UNetConfig, seed: Optional[int], device) -> StateDict:
    """Random U-Net weights with SD-faithful shapes."""
    m = _Maker(seed, device)
    ch = list(cfg.block_channels)
    temb = cfg.time_embed_dim
    m.linear("time_embedding.linear_1", cfg.freq_dim or ch[0], temb)
    m.linear("time_embedding.linear_2", temb, temb)
    m.conv("conv_in", cfg.in_channels, ch[0])
    skip_chs = [ch[0]]
    in_ch = ch[0]
    for lvl in range(cfg.levels):
        out_ch = ch[lvl]
        for j in range(cfg.layers_per_block):
            m.resnet(f"down_blocks.{lvl}.resnets.{j}", in_ch, out_ch, temb)
            if cfg.attn_levels[lvl]:
                _init_spatial_transformer(m, f"down_blocks.{lvl}.attentions.{j}",
                                          out_ch, cfg)
            in_ch = out_ch
            skip_chs.append(out_ch)
        if lvl != cfg.levels - 1:
            m.conv(f"down_blocks.{lvl}.downsamplers.0.conv", out_ch, out_ch)
            skip_chs.append(out_ch)
    m.resnet("mid_block.resnets.0", ch[-1], ch[-1], temb)
    _init_spatial_transformer(m, "mid_block.attentions.0", ch[-1], cfg)
    m.resnet("mid_block.resnets.1", ch[-1], ch[-1], temb)
    in_ch = ch[-1]
    for pos, lvl in enumerate(reversed(range(cfg.levels))):
        out_ch = ch[lvl]
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"up_blocks.{pos}.resnets.{j}", in_ch + skip_chs.pop(),
                     out_ch, temb)
            if cfg.attn_levels[lvl]:
                _init_spatial_transformer(m, f"up_blocks.{pos}.attentions.{j}",
                                          out_ch, cfg)
            in_ch = out_ch
        if lvl != 0:
            m.conv(f"up_blocks.{pos}.upsamplers.0.conv", out_ch, out_ch)
    m.norm("conv_norm_out", ch[0])
    m.conv("conv_out", ch[0], cfg.out_channels)
    return m.sd


def init_text_encoder(cfg: TextEncoderConfig, seed: Optional[int],
                      device) -> StateDict:
    """Random text-encoder weights under the names of its ``arch``
    (:func:`encoder_entries`): embeddings N(0, 0.02²) and N(0, 0.01²), as
    the JAX package draws them."""
    m = _Maker(seed, device)
    d, inner = cfg.hidden_dim, cfg.inner_dim
    names = {path: name for path, name, _ in encoder_entries(cfg)}

    def base(i, leaf):
        return names[("layers", i) + leaf].rsplit(".", 1)[0]

    m.normal(names[("token_embed",)], (cfg.vocab_size, d), 0.02)
    m.normal(names[("pos_embed",)], (cfg.max_length, d), 0.01)
    for i in range(cfg.num_layers):
        m.norm(base(i, ("ln1", "scale")), d)
        for proj in ("q", "k", "v"):
            m.linear(base(i, (proj, "kernel")), d, inner, bias=cfg.attn_qkv_bias)
        m.linear(base(i, ("out", "kernel")), inner, d)
        m.norm(base(i, ("ln2", "scale")), d)
        m.linear(base(i, ("fc1", "kernel")), d, d * cfg.ff_mult)
        m.linear(base(i, ("fc2", "kernel")), d * cfg.ff_mult, d)
    m.norm(names[("final_ln", "scale")].rsplit(".", 1)[0], d)
    return m.sd


def _init_vae_mid(m: _Maker, name: str, ch: int):
    m.resnet(name + ".resnets.0", ch, ch, None)
    attn = name + ".attentions.0"
    m.norm(attn + ".group_norm", ch)
    for proj in ("query", "key", "value", "proj_attn"):
        m.linear(f"{attn}.{proj}", ch, ch)
    m.resnet(name + ".resnets.1", ch, ch, None)


def init_vae(cfg: VAEConfig, seed: Optional[int], device) -> StateDict:
    """Random autoencoder weights (encoder and decoder). The VQ kind's
    encoder gives the embedding itself (``latent_channels`` wide, where the
    KL kind's gives mean and log-variance), and its codebook is drawn from
    U(±1/``num_codebook``), as the JAX package draws it."""
    if cfg.kind not in ("kl", "vq"):
        raise ValueError(f"unknown VAE kind: {cfg.kind!r}")
    m = _Maker(seed, device)
    chs = [cfg.base_channels * mult for mult in cfg.channel_mults]
    top, lat = chs[-1], cfg.latent_channels
    m.conv("encoder.conv_in", cfg.in_channels, chs[0])
    in_ch = chs[0]
    for lvl, out_ch in enumerate(chs):
        for j in range(cfg.layers_per_block):
            m.resnet(f"encoder.down_blocks.{lvl}.resnets.{j}", in_ch, out_ch, None)
            in_ch = out_ch
        if lvl != len(chs) - 1:
            m.conv(f"encoder.down_blocks.{lvl}.downsamplers.0.conv", out_ch, out_ch)
    _init_vae_mid(m, "encoder.mid_block", top)
    m.norm("encoder.conv_norm_out", top)
    moments = lat if cfg.kind == "vq" else 2 * lat
    m.conv("encoder.conv_out", top, moments)
    m.conv("quant_conv", moments, moments, k=1)
    if cfg.kind == "vq":
        cb = torch.empty((cfg.num_codebook, lat), dtype=torch.float32,
                         device=m.device)
        if m.gen is not None:
            cb.uniform_(-1.0 / cfg.num_codebook, 1.0 / cfg.num_codebook,
                        generator=m.gen)
        m.sd["quantize.embedding.weight"] = cb
    m.conv("post_quant_conv", lat, lat, k=1)
    m.conv("decoder.conv_in", lat, top)
    _init_vae_mid(m, "decoder.mid_block", top)
    in_ch = top
    for pos, lvl in enumerate(reversed(range(len(chs)))):
        out_ch = chs[lvl]
        for j in range(cfg.layers_per_block + 1):
            m.resnet(f"decoder.up_blocks.{pos}.resnets.{j}", in_ch, out_ch, None)
            in_ch = out_ch
        if lvl != 0:
            m.conv(f"decoder.up_blocks.{pos}.upsamplers.0.conv", out_ch, out_ch)
    m.norm("decoder.conv_norm_out", chs[0])
    m.conv("decoder.conv_out", chs[0], cfg.in_channels)
    return m.sd
