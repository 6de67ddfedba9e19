"""The sampling engine: text → image under attention control.

The PyTorch counterpart of the ungated path of
``p2p_tpu/engine/sampler.py``: the denoising loop is a Python loop over the
DDIM timesteps whose body is the JAX package's scan body
(classifier-free guidance by batch doubling, one U-Net call on
``[uncond; cond]``, the controller hook at every attention site, the
scheduler step, the latent hook); the store state is carried explicitly.
All prompts of an edit group start from one latent. A null-text replay
substitutes each step's optimized uncond embedding
(``uncond_embeddings``, from ``engine.inversion.invert``).

Entry points run on CUDA unless ``device="cpu"`` is asked for; with no GPU
and no ``device`` they raise. On CUDA, TF32 is switched off for matmuls and
convolutions: the JAX reference is f32 throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..controllers.base import (
    AttnLayout,
    Controller,
    StoreState,
    apply_step_callback,
    init_store_state,
)
from ..models import vae as vae_mod
from ..models.checkpoint import StateDict
from ..models.config import PipelineConfig, unet_layout
from ..models.text_encoder import apply_text_encoder
from ..models.unet import apply_unet
from ..ops import schedulers as sched_mod
from ..utils.tokenizer import Tokenizer, pad_ids


def resolve_device(device=None) -> torch.device:
    """``device``, or CUDA when it is None. Raises when CUDA is asked for
    (explicitly or by default) and there is none: the port never falls back
    to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A bound backend: config, weights (diffusers-named state dicts on one
    device) and tokenizer."""

    config: PipelineConfig
    unet: StateDict
    text_encoder: StateDict
    vae: StateDict
    tokenizer: Tokenizer

    @property
    def device(self) -> torch.device:
        return next(iter(self.unet.values())).device

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        s = self.config.latent_size
        return (s, s, self.config.unet.in_channels)


def random_pipeline(config: PipelineConfig, tokenizer: Tokenizer, device,
                    seed: int = 0) -> Pipeline:
    """A pipeline of random weights (the JAX package's init scheme), made
    on ``device`` from seeds ``seed``, ``seed + 1``, ``seed + 2``."""
    from ..models.checkpoint import init_text_encoder, init_unet, init_vae

    device = resolve_device(device)
    return Pipeline(config=config,
                    unet=init_unet(config.unet, seed, device),
                    text_encoder=init_text_encoder(config.text, seed + 1, device),
                    vae=init_vae(config.vae, seed + 2, device),
                    tokenizer=tokenizer)


def encode_prompts(pipe: Pipeline, prompts: Sequence[str]) -> torch.Tensor:
    """Tokenize and encode to ``(B, L, D)`` hidden states."""
    tok = pipe.tokenizer
    max_len = pipe.config.unet.context_len
    pad = getattr(tok, "pad_token_id", tok.eos_token_id)
    ids = torch.tensor([pad_ids(tok.encode(p), max_len, pad) for p in prompts],
                       dtype=torch.int64, device=pipe.device)
    return apply_text_encoder(pipe.text_encoder, pipe.config.text, ids)


def init_latent(latent: Optional[torch.Tensor], shape: Tuple[int, ...],
                generator: Optional[torch.Generator], batch: int,
                dtype=torch.float32, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One latent ``(1, H, W, C)`` — the given one, or a normal draw from
    ``generator`` — expanded over the edit group. Returns (single, batched)."""
    if latent is None:
        if generator is None:
            raise ValueError("init_latent needs a latent or a generator")
        latent = torch.randn((1,) + tuple(shape), generator=generator,
                             dtype=dtype, device=generator.device)
    latent = latent.to(device=device, dtype=dtype)
    return latent, latent.expand((batch,) + tuple(latent.shape[1:])).contiguous()


def denoise(pipe: Pipeline, context: torch.Tensor, latents: torch.Tensor,
            controller: Optional[Controller], *, num_steps: int,
            guidance_scale: float, scheduler: str = "ddim",
            layout: Optional[AttnLayout] = None, kernels=None,
            uncond_embeddings: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, StoreState]:
    """The denoising loop. ``context``: ``(2B, L, D)`` as
    ``[uncond; cond]``; ``latents``: ``(B, H, W, C)``;
    ``uncond_embeddings``: ``(T, 1, L, D)`` or None — step i's row replaces
    the uncond half of the context, broadcast over B. Returns the final
    latents and the store state."""
    cfg = pipe.config
    layout = layout or unet_layout(cfg.unet)
    b = latents.shape[0]
    sched = sched_mod.schedule_from_config(num_steps, cfg.scheduler,
                                           kind=scheduler, device=latents.device)
    state = (init_store_state(layout, b, device=latents.device)
             if controller is not None and controller.needs_store else ())
    for step, t in enumerate(sched.timesteps.tolist()):
        ctx = context
        if uncond_embeddings is not None:
            u = uncond_embeddings[step].to(context.dtype)
            ctx = torch.cat([u.expand_as(context[:b]), context[b:]], dim=0)
        latent_in = torch.cat([latents] * 2, dim=0)
        eps, state = apply_unet(pipe.unet, cfg.unet, latent_in, t, ctx,
                                layout=layout, controller=controller,
                                state=state, step=step, kernels=kernels)
        eps_uncond, eps_text = eps[:b], eps[b:]
        eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        eps = sched_mod.to_epsilon(sched, eps, t, latents)
        latents = sched_mod.ddim_step(sched, eps, t, latents)
        latents = apply_step_callback(controller, layout, state, latents, step)
    return latents, state


def text2image(
    pipe: Pipeline,
    prompts: Sequence[str],
    controller: Optional[Controller] = None,
    *,
    num_steps: Optional[int] = None,
    guidance_scale: Optional[float] = None,
    scheduler: str = "ddim",
    latent: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    uncond_embeddings: Optional[torch.Tensor] = None,
    negative_prompt: Optional[str] = None,
    layout: Optional[AttnLayout] = None,
    dtype=torch.float32,
    return_store: bool = False,
    kernels=None,
    device=None,
    return_latents: bool = False,
    gate=None,
    schedule=None,
):
    """Generate an edit group of images from prompts under attention
    control. Returns ``(images uint8 (B, H, W, 3), x_T (1, h, w, c), store)``
    as the JAX package does, with the final latents ``(B, h, w, c)`` as a
    fourth element when ``return_latents``.

    ``latent`` fixes x_T; otherwise it is drawn from ``generator`` (a
    ``torch.Generator``; seed 0 on the device when None). ``kernels`` (a
    ``kernels.KernelConfig``) sends covered, kernel-compilable edited sites
    to the fused-edit kernel. ``negative_prompt`` replaces the ``""``
    unconditional text. ``uncond_embeddings`` ``(T, 1, L, D)`` (a null-text
    inversion's, T = ``num_steps``, DDIM only) replaces it step by step
    instead. Phase gating (``gate``) and reuse schedules (``schedule``) are
    not ported yet and raise."""
    if gate is not None or schedule is not None:
        raise NotImplementedError("gate / schedule are not ported to "
                                  "p2p_tpu_torch yet")
    if negative_prompt and uncond_embeddings is not None:
        raise ValueError("negative_prompt and uncond_embeddings are mutually "
                         "exclusive (null-text already optimized the uncond)")
    if dtype != torch.float32:
        raise NotImplementedError("p2p_tpu_torch samples in float32 only")
    device = resolve_device(device)
    if pipe.device.type != device.type:
        raise ValueError(f"the pipeline's weights are on {pipe.device}, "
                         f"sampling was asked for on {device}")
    if controller is not None:
        controller = controller.to(device)
    cfg = pipe.config
    num_steps = num_steps or cfg.num_steps
    if uncond_embeddings is not None:
        if scheduler != "ddim":
            raise ValueError("uncond_embeddings require scheduler='ddim'")
        if uncond_embeddings.shape[0] != num_steps:
            raise ValueError(
                f"uncond_embeddings has {uncond_embeddings.shape[0]} steps, "
                f"sampling uses {num_steps}")
        uncond_embeddings = torch.as_tensor(uncond_embeddings, device=device)
    gs = cfg.guidance_scale if guidance_scale is None else guidance_scale
    if generator is None and latent is None:
        generator = torch.Generator(device).manual_seed(0)

    with torch.no_grad():
        context = torch.cat([
            encode_prompts(pipe, [negative_prompt or ""] * len(prompts)),
            encode_prompts(pipe, prompts)], dim=0)
        x_t, latents = init_latent(latent, pipe.latent_shape, generator,
                                   len(prompts), device=device)
        latents, state = denoise(pipe, context, latents, controller,
                                 num_steps=num_steps, guidance_scale=gs,
                                 scheduler=scheduler, layout=layout,
                                 kernels=kernels,
                                 uncond_embeddings=uncond_embeddings)
        images = vae_mod.to_uint8(vae_mod.decode(pipe.vae, cfg.vae, latents))
    out = (images, x_t, state if return_store else ())
    return out + (latents,) if return_latents else out
