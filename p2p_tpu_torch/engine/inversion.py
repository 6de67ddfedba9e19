"""Null-text inversion: DDIM inversion, then a per-step optimization of the
unconditional text embedding so that CFG sampling reproduces the image.

The PyTorch counterpart of ``p2p_tpu/engine/inversion.py``:

1. :func:`ddim_invert` — a loop over ascending timesteps with guidance 1
   (cond-only ε), recording all T+1 latents;
2. :func:`null_optimize` — a loop over the T outer steps; each step starts
   a fresh Adam state over the uncond embedding and runs at most
   ``num_inner_steps`` gradient iterations with the decaying learning rate
   ``0.01·(1 − i/(2T))``, stopping early once the loss before an update
   falls below ``ε + i·2e-5``; the latent then advances one DDIM step under
   full CFG with the optimized embedding.

The gradient runs through the U-Net by autograd; at the self sites of
``FLASH_MIN_SEQ`` pixels or more (SD-1.4's 64² sites at head dim 40,
SD-2.1's 96² and 48² or 64² sites at head dim 64) that is the flash
forward with residuals (K3) and the flash backward (K4), through
``models.nn.fused_attention``. Only the embedding takes gradients: no
weight requires grad. SD-2.1 768-v predicts v: ``ddim_invert`` and the
inner loss convert the U-Net's output to ε (``to_epsilon``) as the JAX
package does.

``invert(dtype=torch.bfloat16)`` runs it as the JAX package's production
inversion does: the image, the VAE encode (K1 at d = 512 in bf16), the text
encoder, the U-Net and the latents in bf16; the embedding and its Adam
state in f32, cast to bf16 at each U-Net call; classifier-free guidance
promoted to f32 by the f32 guidance scale; the loss's DDIM step and
comparison in f32; the reconstruction's decode in f32.

:func:`invert` returns an :class:`InversionArtifact` (x_T and the
per-step embeddings) whose ``.npz`` has the JAX package's keys, so an
artifact written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.flash_bwd import SUPPORTED_HEAD_DIMS as K4_HEAD_DIMS
from ..models import vae as vae_mod
from ..models.config import PipelineConfig, unet_attn_specs
from ..models.nn import FLASH_MIN_SEQ
from ..models.unet import apply_unet
from ..ops import schedulers as sched_mod
from .sampler import Pipeline, encode_prompts, resolve_device


@dataclasses.dataclass
class InversionArtifact:
    """What :func:`invert` produces: everything a replay needs.

    ``inner_steps`` — the Adam iterations each outer step ran before its
    early stop — is reported beside the artifact and not saved."""

    x_t: np.ndarray                  # (1, h, w, c) inverted terminal latent
    uncond_embeddings: np.ndarray    # (T, 1, L, D) per-step optimized uncond
    prompt: str
    num_steps: int
    image_gt: Optional[np.ndarray] = None   # (H, W, 3) uint8
    image_rec: Optional[np.ndarray] = None  # VAE round-trip reconstruction
    inner_steps: Optional[List[int]] = None

    def save(self, path: str) -> None:
        np.savez(path, x_t=self.x_t, uncond_embeddings=self.uncond_embeddings,
                 prompt=np.asarray(self.prompt), num_steps=self.num_steps,
                 image_gt=self.image_gt if self.image_gt is not None else np.zeros(0),
                 image_rec=self.image_rec if self.image_rec is not None else np.zeros(0))

    @classmethod
    def load(cls, path: str) -> "InversionArtifact":
        """Read an artifact of either package. The JAX package's bf16
        inversion saves ``x_t`` as an ml_dtypes bfloat16 array, which numpy
        reads as 2-byte void items; those are bf16 bit patterns, widened
        here to the f32 values they hold."""
        z = np.load(path, allow_pickle=False)
        gt = z["image_gt"]
        rec = z["image_rec"]
        x_t = z["x_t"]
        if x_t.dtype.kind == "V" and x_t.dtype.itemsize == 2:
            x_t = (x_t.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return cls(x_t=x_t, uncond_embeddings=z["uncond_embeddings"],
                   prompt=str(z["prompt"]), num_steps=int(z["num_steps"]),
                   image_gt=gt if gt.size else None,
                   image_rec=rec if rec.size else None)


def load_image(path: str, size: int = 512, left: int = 0, right: int = 0,
               top: int = 0, bottom: int = 0) -> np.ndarray:
    """Crop, centre-square and resize an image file to ``(size, size, 3)``
    uint8; each crop offset is clamped against its own axis."""
    from PIL import Image

    img = np.array(Image.open(path).convert("RGB"))
    h, w = img.shape[:2]
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    top = min(top, h - 1)
    bottom = min(bottom, h - top - 1)
    img = img[top:h - bottom, left:w - right]
    h, w = img.shape[:2]
    if h < w:
        off = (w - h) // 2
        img = img[:, off:off + h]
    elif w < h:
        off = (h - w) // 2
        img = img[off:off + w]
    return np.array(Image.fromarray(img).resize((size, size)))


def require_k4(config: PipelineConfig, what: str) -> None:
    """Raise ``NotImplementedError`` naming ``what`` when the null-text
    gradient of ``config``'s U-Net needs K4, the flash attention backward,
    at a head dim it has no kernel for: the head dims of the self sites at
    ``FLASH_MIN_SEQ`` positions or more. Every preset passes (SD-1.4 at
    head dim 40, SD-2.1 at 64)."""
    dims = {ch // heads for _, cross, res, heads, _, ch in unet_attn_specs(config.unet)
            if not cross and res * res >= FLASH_MIN_SEQ}
    missing = sorted(dims - set(K4_HEAD_DIMS))
    if missing:
        raise NotImplementedError(
            f"{what}: the null-text inversion needs K4, the flash attention "
            f"backward, at head dim {', '.join(map(str, missing))}, which "
            "p2p_tpu_torch does not have yet")


def ddim_invert(pipe: Pipeline, schedule: sched_mod.DiffusionSchedule,
                image: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image ``(1, H, W, 3)`` in [-1, 1] → ``(latent0, x_T, latents)``,
    ``latents`` the T+1 latents ``(T+1, 1, h, w, c)`` in ascending noise,
    all in ``image``'s dtype (the compute dtype), ``cond`` in it too."""
    cfg = pipe.config
    unet_sd = pipe.weights(image.dtype)[0]
    with torch.no_grad():
        latent = vae_mod.encode(pipe.vae_encoder_weights(image.dtype), cfg.vae, image)
        latents = [latent]
        for t in reversed(schedule.timesteps.tolist()):
            eps, _ = apply_unet(unet_sd, cfg.unet, latent, t, cond)
            eps = sched_mod.to_epsilon(schedule, eps, t, latent)
            latent = sched_mod.ddim_next_step(schedule, eps, t, latent)
            latents.append(latent)
    return latents[0], latent, torch.stack(latents)


def _adam_update(g, m, v, j: float, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
    """One Adam step written out (torch.optim.Adam's defaults and order):
    returns ``(update, m, v)`` for iteration ``j`` (1-based). The bias
    corrections are taken in f32, as the JAX package takes them."""
    f32 = np.float32
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * (g * g)
    mhat = m / float(f32(1) - f32(b1) ** f32(j))
    vhat = v / float(f32(1) - f32(b2) ** f32(j))
    return -lr * mhat / (torch.sqrt(vhat) + eps), m, v


def _cfg_eps(pipe, schedule, latent, t, uncond, eps_cond, guidance_scale):
    """ε under CFG with the uncond half recomputed from ``uncond`` (f32,
    cast to ``eps_cond``'s dtype, the compute dtype), taken as
    ``sampler.denoise`` takes it: promoted to f32 by the JAX package's f32
    guidance scale, the difference unrounded (XLA drops its round trip
    through bf16)."""
    eps_u, _ = apply_unet(pipe.weights(eps_cond.dtype)[0], pipe.config.unet,
                          latent, t, uncond.to(eps_cond.dtype))
    eps = eps_u.float() + guidance_scale * (eps_cond.float() - eps_u.float())
    return sched_mod.to_epsilon(schedule, eps, t, latent)


def null_text_loss(pipe: Pipeline, schedule: sched_mod.DiffusionSchedule,
                   latent: torch.Tensor, t: int, uncond: torch.Tensor,
                   eps_cond: torch.Tensor, target: torch.Tensor,
                   guidance_scale: float) -> torch.Tensor:
    """The inner loss at one outer step: the mean squared distance, in
    f32, between the CFG DDIM step from ``latent`` with uncond embedding
    ``uncond`` and the recorded ``target`` one step less noisy.
    ``eps_cond`` is the (gradient-free) conditional ε at ``latent``, in the
    compute dtype; ``uncond`` is f32 and is cast to it for the U-Net."""
    eps = _cfg_eps(pipe, schedule, latent, t, uncond, eps_cond, guidance_scale)
    prev = sched_mod.ddim_step(schedule, eps, t, latent.float())
    return torch.mean(torch.square(prev - target.float()))


def null_optimize(pipe: Pipeline, schedule: sched_mod.DiffusionSchedule,
                  latents: torch.Tensor, uncond0: torch.Tensor,
                  cond: torch.Tensor, guidance_scale: float,
                  num_inner_steps: int, epsilon: float
                  ) -> Tuple[torch.Tensor, List[int]]:
    """Per-step optimization of the uncond embedding. ``latents``: the
    ``(T+1, 1, h, w, c)`` ascending inversion latents; ``uncond0``,
    ``cond``: ``(1, L, D)``. Returns the ``(T, 1, L, D)`` f32 embeddings and
    the inner iterations each outer step ran.

    The embedding and its Adam state stay f32; the loss's step math and
    comparison run in f32; the U-Net and the latents run in ``cond``'s
    dtype, the compute dtype. The schedule constants (learning rate, stop
    threshold) are taken in f32, as the JAX package takes them."""
    t_count = schedule.timesteps.shape[0]
    unet_sd = pipe.weights(cond.dtype)[0]
    latent_cur = latents[-1]
    uncond = uncond0.float()
    out, counts = [], []
    for i, t in enumerate(schedule.timesteps.tolist()):
        lr = float(np.float32(0.01) * (np.float32(1.0) - np.float32(i)
                                       / np.float32(2.0 * t_count)))
        stop_at = np.float32(epsilon) + np.float32(i) * np.float32(2e-5)
        target = latents[t_count - 1 - i]
        with torch.no_grad():
            eps_cond, _ = apply_unet(unet_sd, pipe.config.unet, latent_cur,
                                     t, cond)
        u = uncond
        m = torch.zeros_like(u)
        v = torch.zeros_like(u)
        j, loss = 0, np.float32(np.inf)
        # The loss tested is the one before each update, as the reference's
        # loop tests the loss of the step it has just taken.
        while j < num_inner_steps and loss >= stop_at:
            u_var = u.detach().requires_grad_(True)
            with torch.enable_grad():
                loss_t = null_text_loss(pipe, schedule, latent_cur, t, u_var,
                                        eps_cond, target, guidance_scale)
                (g,) = torch.autograd.grad(loss_t, u_var)
            # The early-stop test needs the loss on the host: one sync per
            # inner iteration, and the loop's only one.
            loss = np.float32(loss_t.item())
            upd, m, v = _adam_update(g, m, v, j + 1.0, lr)
            u = u + upd
            j += 1
        counts.append(j)
        out.append(u)
        uncond = u
        with torch.no_grad():
            eps = _cfg_eps(pipe, schedule, latent_cur, t, u, eps_cond,
                           guidance_scale)
            latent_cur = sched_mod.ddim_step(schedule, eps, t, latent_cur)
    return torch.stack(out), counts


def invert(pipe: Pipeline, image, prompt: str, *, num_steps: int = 50,
           guidance_scale: Optional[float] = None, num_inner_steps: int = 10,
           early_stop_epsilon: float = 1e-5, dtype=torch.float32, gate=None,
           device=None) -> InversionArtifact:
    """Null-text inversion of ``image`` (``(H, W, 3)`` uint8, or
    ``(1, H, W, 3)`` float in [-1, 1]) under ``prompt``: DDIM-invert with
    guidance 1, then optimize per-step uncond embeddings so CFG sampling at
    full guidance reproduces the image. The result's ``inner_steps`` lists
    the Adam iterations of each outer step.

    ``dtype`` is the compute dtype, ``torch.float32`` or ``torch.bfloat16``
    (the JAX package's production dtype; see the module docstring); the
    artifact's x_T is f32 either way, holding the bf16 values exactly in
    bf16, and its embeddings are f32.

    ``gate`` must be None or ``num_steps``: the optimization targets the
    uncond branch at every step, which phase gating would drop. Runs on
    CUDA unless ``device="cpu"`` is asked for."""
    if gate is not None and gate != num_steps:
        raise ValueError(
            f"null-text inversion is incompatible with phase-gated sampling "
            f"(gate={gate!r}): the optimization targets a per-step uncond "
            "embedding at every DDIM step, which CFG truncation would drop. "
            "Run invert() with gate=None.")
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"p2p_tpu_torch inverts in float32 or "
                                  f"bfloat16, not {dtype}")
    device = resolve_device(device)
    if pipe.device.type != device.type:
        raise ValueError(f"the pipeline's weights are on {pipe.device}, "
                         f"inversion was asked for on {device}")
    cfg = pipe.config
    gs = cfg.guidance_scale if guidance_scale is None else guidance_scale
    image = np.asarray(image)
    if image.dtype == np.uint8:
        image_f = image.astype(np.float32) / 127.5 - 1.0
    else:
        image_f = image.astype(np.float32)
    if image_f.ndim == 3:
        image_f = image_f[None]
    schedule = sched_mod.schedule_from_config(num_steps, cfg.scheduler,
                                              kind="ddim", device=device)
    with torch.no_grad():
        cond = encode_prompts(pipe, [prompt], dtype)
        uncond0 = encode_prompts(pipe, [""], dtype)
    latent0, x_t, all_latents = ddim_invert(
        pipe, schedule, torch.from_numpy(image_f).to(device, dtype), cond)
    uncond_list, counts = null_optimize(
        pipe, schedule, all_latents, uncond0, cond, gs, num_inner_steps,
        early_stop_epsilon)
    with torch.no_grad():
        rec = vae_mod.to_uint8(vae_mod.decode(pipe.vae, cfg.vae, latent0.float()))
    gt = image if image.dtype == np.uint8 else vae_mod.to_uint8(
        torch.from_numpy(image_f))[0].numpy()
    return InversionArtifact(
        x_t=x_t.float().cpu().numpy(),
        uncond_embeddings=uncond_list.cpu().numpy(),
        prompt=prompt,
        num_steps=num_steps,
        image_gt=np.asarray(gt).reshape(image_f.shape[1:]),
        image_rec=rec[0].cpu().numpy(),
        inner_steps=counts,
    )
