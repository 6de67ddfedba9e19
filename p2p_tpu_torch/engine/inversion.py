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

The gradient runs through the U-Net by autograd; at the 64²-pixel self
sites that is the flash forward with residuals (K3) and the flash backward
(K4), through ``models.nn.fused_attention``. Only the embedding takes
gradients: no weight requires grad.

:func:`invert` returns an :class:`InversionArtifact` (x_T and the
per-step embeddings) whose ``.npz`` has the JAX package's keys, so an
artifact written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import vae as vae_mod
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
        z = np.load(path, allow_pickle=False)
        gt = z["image_gt"]
        rec = z["image_rec"]
        return cls(x_t=z["x_t"], uncond_embeddings=z["uncond_embeddings"],
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


def ddim_invert(pipe: Pipeline, schedule: sched_mod.DiffusionSchedule,
                image: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image ``(1, H, W, 3)`` in [-1, 1] → ``(latent0, x_T, latents)``,
    ``latents`` the T+1 latents ``(T+1, 1, h, w, c)`` in ascending noise."""
    cfg = pipe.config
    with torch.no_grad():
        latent = vae_mod.encode(pipe.vae, cfg.vae, image)
        latents = [latent]
        for t in reversed(schedule.timesteps.tolist()):
            eps, _ = apply_unet(pipe.unet, cfg.unet, latent, t, cond)
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
    """ε under CFG with the uncond half recomputed from ``uncond``."""
    eps_u, _ = apply_unet(pipe.unet, pipe.config.unet, latent, t, uncond)
    eps = eps_u + guidance_scale * (eps_cond - eps_u)
    return sched_mod.to_epsilon(schedule, eps, t, latent)


def null_text_loss(pipe: Pipeline, schedule: sched_mod.DiffusionSchedule,
                   latent: torch.Tensor, t: int, uncond: torch.Tensor,
                   eps_cond: torch.Tensor, target: torch.Tensor,
                   guidance_scale: float) -> torch.Tensor:
    """The inner loss at one outer step: the mean squared distance, in
    f32, between the CFG DDIM step from ``latent`` with uncond embedding
    ``uncond`` and the recorded ``target`` one step less noisy.
    ``eps_cond`` is the (gradient-free) conditional ε at ``latent``."""
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
    comparison run in f32. The schedule constants (learning rate, stop
    threshold) are taken in f32, as the JAX package takes them."""
    t_count = schedule.timesteps.shape[0]
    latent_cur = latents[-1]
    uncond = uncond0.float()
    out, counts = [], []
    for i, t in enumerate(schedule.timesteps.tolist()):
        lr = float(np.float32(0.01) * (np.float32(1.0) - np.float32(i)
                                       / np.float32(2.0 * t_count)))
        stop_at = np.float32(epsilon) + np.float32(i) * np.float32(2e-5)
        target = latents[t_count - 1 - i]
        with torch.no_grad():
            eps_cond, _ = apply_unet(pipe.unet, pipe.config.unet, latent_cur,
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

    ``gate`` must be None or ``num_steps``: the optimization targets the
    uncond branch at every step, which phase gating would drop. Runs on
    CUDA unless ``device="cpu"`` is asked for."""
    if gate is not None and gate != num_steps:
        raise ValueError(
            f"null-text inversion is incompatible with phase-gated sampling "
            f"(gate={gate!r}): the optimization targets a per-step uncond "
            "embedding at every DDIM step, which CFG truncation would drop. "
            "Run invert() with gate=None.")
    if dtype != torch.float32:
        raise NotImplementedError("p2p_tpu_torch inverts in float32 only")
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
        cond = encode_prompts(pipe, [prompt])
        uncond0 = encode_prompts(pipe, [""])
    latent0, x_t, all_latents = ddim_invert(
        pipe, schedule, torch.from_numpy(image_f).to(device), cond)
    uncond_list, counts = null_optimize(
        pipe, schedule, all_latents, uncond0, cond, gs, num_inner_steps,
        early_stop_epsilon)
    with torch.no_grad():
        rec = vae_mod.to_uint8(vae_mod.decode(pipe.vae, cfg.vae, latent0))
    gt = image if image.dtype == np.uint8 else vae_mod.to_uint8(
        torch.from_numpy(image_f))[0].numpy()
    return InversionArtifact(
        x_t=x_t.cpu().numpy(),
        uncond_embeddings=uncond_list.cpu().numpy(),
        prompt=prompt,
        num_steps=num_steps,
        image_gt=np.asarray(gt).reshape(image_f.shape[1:]),
        image_rec=rec[0].cpu().numpy(),
        inner_steps=counts,
    )
