"""The sampling engine: text → image under attention control.

The PyTorch counterpart of the ungated path of
``p2p_tpu/engine/sampler.py``: the denoising loop is a Python loop over the
scheduler's timesteps (DDIM, PLMS or DPM-Solver++) whose body is the JAX
package's scan body (classifier-free guidance by batch doubling, one U-Net
call on ``[uncond; cond]``, the controller hook at every attention site,
the scheduler step, the latent hook); the store state and the scheduler's
multistep state are carried explicitly, the latter in the latents' dtype.
A PLMS run of T steps makes T + 1 U-Net calls, its step index running to T.
All prompts of an edit group start from one latent. A null-text replay
substitutes each step's optimized uncond embedding
(``uncond_embeddings``, from ``engine.inversion.invert``).

Entry points run on CUDA unless ``device="cpu"`` is asked for; with no GPU
and no ``device`` they raise. On CUDA, TF32 is switched off for matmuls and
convolutions: the JAX reference's f32 is full f32.

``text2image(dtype=torch.bfloat16)`` runs the text encoder and the U-Net in
bf16 as the JAX package does (``p2p_tpu/engine/sampler.py``): their weights
cast once per pipeline (:meth:`Pipeline.weights`), the attention
probabilities, the store and the edit in f32, classifier-free guidance
promoted to f32 by the f32 guidance scale, the scheduler step in f32 on a
bf16 carry, and the VAE decode in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..controllers.base import (
    AttnLayout,
    Controller,
    StoreState,
    apply_step_callback,
    init_store_state,
)
from ..models import checkpoint as ck
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
    _cast: Dict[torch.dtype, Tuple[StateDict, StateDict]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    _cast_encoder: Dict[torch.dtype, StateDict] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return next(iter(self.unet.values())).device

    def weights(self, dtype) -> Tuple[StateDict, StateDict]:
        """The U-Net's and the text encoder's weights for compute in
        ``dtype``: every linear, convolution and embedding tensor cast to
        ``dtype`` once and kept (the JAX package casts at each use, which
        gives the same values), the norms' scales and biases left f32, as
        both norm paths read them in f32. The f32 weights themselves for
        f32."""
        if dtype == torch.float32:
            return self.unet, self.text_encoder
        if dtype not in self._cast:
            def cast(sd, entries):
                keep = ck.norm_names(entries)
                return {n: t if n in keep else t.to(dtype) for n, t in sd.items()}

            cfg = self.config
            self._cast[dtype] = (cast(self.unet, ck.unet_entries(cfg.unet)),
                                 cast(self.text_encoder,
                                      ck.encoder_entries(cfg.text)))
        return self._cast[dtype]

    def vae_encoder_weights(self, dtype) -> StateDict:
        """The VAE's weights for an encode in ``dtype``: the encoder's and
        ``quant_conv``'s convolution and linear tensors cast to ``dtype``
        once and kept, as :meth:`weights` casts the U-Net's, the norms'
        scales and biases f32; the decoder's left out (the decode runs in
        f32 on ``vae``). The f32 weights themselves for f32."""
        if dtype == torch.float32:
            return self.vae
        if dtype not in self._cast_encoder:
            keep = ck.norm_names(ck.vae_entries(self.config.vae))
            self._cast_encoder[dtype] = {
                n: t if n in keep else t.to(dtype) for n, t in self.vae.items()
                if n.startswith(("encoder.", "quant_conv."))}
        return self._cast_encoder[dtype]

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


def encode_prompts(pipe: Pipeline, prompts: Sequence[str],
                   dtype=torch.float32) -> torch.Tensor:
    """Tokenize and encode to ``(B, L, D)`` hidden states in ``dtype``."""
    tok = pipe.tokenizer
    max_len = pipe.config.unet.context_len
    pad = getattr(tok, "pad_token_id", tok.eos_token_id)
    ids = torch.tensor([pad_ids(tok.encode(p), max_len, pad) for p in prompts],
                       dtype=torch.int64, device=pipe.device)
    return apply_text_encoder(pipe.weights(dtype)[1], pipe.config.text, ids,
                              dtype=dtype)


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
    ``[uncond; cond]``; ``latents``: ``(B, H, W, C)``, in the compute dtype;
    ``uncond_embeddings``: ``(T, 1, L, D)`` or None — step i's row replaces
    the uncond half of the context, broadcast over B. Returns the final
    latents and the store state.

    Guidance is taken as the JAX package takes it with its f32 guidance
    scale: the difference in the compute dtype, then promoted to f32."""
    cfg = pipe.config
    unet_sd = pipe.weights(latents.dtype)[0]
    layout = layout or unet_layout(cfg.unet)
    b = latents.shape[0]
    sched = sched_mod.schedule_from_config(num_steps, cfg.scheduler,
                                           kind=scheduler, device=latents.device)
    state = (init_store_state(layout, b, device=latents.device)
             if controller is not None and controller.needs_store else ())
    ms = sched_mod.init_multistep_state(scheduler, latents.shape, latents.dtype,
                                        latents.device)
    for step, t in enumerate(sched.timesteps.tolist()):
        ctx = context
        if uncond_embeddings is not None:
            u = uncond_embeddings[step].to(context.dtype)
            ctx = torch.cat([u.expand_as(context[:b]), context[b:]], dim=0)
        latent_in = torch.cat([latents] * 2, dim=0)
        eps, state = apply_unet(unet_sd, cfg.unet, latent_in, t, ctx,
                                layout=layout, controller=controller,
                                state=state, step=step, kernels=kernels)
        eps_uncond, eps_text = eps[:b], eps[b:]
        eps = eps_uncond.float() + guidance_scale * (eps_text.float() - eps_uncond.float())
        eps = sched_mod.to_epsilon(sched, eps, t, latents)
        ms, latents = sched_mod.multistep_step(sched, scheduler, ms, eps, t,
                                               latents)
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
    ``torch.Generator``; seed 0 on the device when None). ``scheduler`` is
    ``"ddim"``, ``"plms"`` or ``"dpm"``. ``kernels`` (a
    ``kernels.KernelConfig``) sends covered, kernel-compilable edited sites
    to the fused-edit kernel. ``negative_prompt`` replaces the ``""``
    unconditional text. ``uncond_embeddings`` ``(T, 1, L, D)`` (a null-text
    inversion's, T = ``num_steps``, DDIM only) replaces it step by step
    instead; each step's row is cast to ``dtype``. ``dtype`` is the compute
    dtype of the text encoder and the U-Net, ``torch.float32`` or
    ``torch.bfloat16``; the final latents come back in it, and the VAE
    decodes them in f32. Phase gating (``gate``) and reuse schedules
    (``schedule``) are not ported yet and raise."""
    if gate is not None or schedule is not None:
        raise NotImplementedError("gate / schedule are not ported to "
                                  "p2p_tpu_torch yet")
    if negative_prompt and uncond_embeddings is not None:
        raise ValueError("negative_prompt and uncond_embeddings are mutually "
                         "exclusive (null-text already optimized the uncond)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"p2p_tpu_torch samples in float32 or "
                                  f"bfloat16, not {dtype}")
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
            encode_prompts(pipe, [negative_prompt or ""] * len(prompts), dtype),
            encode_prompts(pipe, prompts, dtype)], dim=0)
        x_t, latents = init_latent(latent, pipe.latent_shape, generator,
                                   len(prompts), dtype=dtype, device=device)
        latents, state = denoise(pipe, context, latents, controller,
                                 num_steps=num_steps, guidance_scale=gs,
                                 scheduler=scheduler, layout=layout,
                                 kernels=kernels,
                                 uncond_embeddings=uncond_embeddings)
        images = vae_mod.to_uint8(vae_mod.decode(pipe.vae, cfg.vae,
                                                 latents.float()))
    out = (images, x_t, state if return_store else ())
    return out + (latents,) if return_latents else out
