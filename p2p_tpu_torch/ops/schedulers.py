"""The DDIM (η = 0) scheduler — the PyTorch counterpart of the DDIM part of
``p2p_tpu/ops/schedulers.py``.

A :class:`DiffusionSchedule` holds the precomputed constants (computed in
float64 with numpy, stored as f32 as the JAX package stores them); the step
math runs in f32: :func:`ddim_step` samples, :func:`ddim_next_step` inverts
(null-text inversion). ``set_alpha_to_one=False`` semantics: the final step
uses ``alphas_cumprod[0]``, not 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, schedule: str = "scaled_linear"
               ) -> np.ndarray:
    """The SD-1.x β schedule."""
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown beta schedule: {schedule!r}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed sampler constants; ``timesteps`` descend."""

    alphas_cumprod: torch.Tensor         # (num_train,) f32
    timesteps: torch.Tensor              # (num_inference,) int64, descending
    final_alpha_cumprod: torch.Tensor    # scalar f32
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    clip_sample: bool = False
    prediction_type: str = "epsilon"

    @property
    def step_size(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(
            self, alphas_cumprod=self.alphas_cumprod.to(device),
            timesteps=self.timesteps.to(device),
            final_alpha_cumprod=self.final_alpha_cumprod.to(device))


def make_schedule(num_inference_steps: int, num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012,
                  schedule: str = "scaled_linear", set_alpha_to_one: bool = False,
                  steps_offset: int = 0, kind: str = "ddim",
                  clip_sample: bool = False, prediction_type: str = "epsilon",
                  device=None) -> DiffusionSchedule:
    """T timesteps ``[(T-1)·s, ..., 0] + offset``. Only ``kind='ddim'`` is
    ported."""
    if kind != "ddim":
        raise NotImplementedError(f"scheduler {kind!r} is not ported to "
                                  "p2p_tpu_torch (only 'ddim')")
    betas = make_betas(num_train_timesteps, beta_start, beta_end, schedule)
    acp = np.cumprod(1.0 - betas)
    step = num_train_timesteps // num_inference_steps
    base = (np.arange(num_inference_steps) * step).round().astype(np.int64) + steps_offset
    final = acp[0] if not set_alpha_to_one else 1.0
    return DiffusionSchedule(
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32, device=device),
        timesteps=torch.tensor(base[::-1].copy(), dtype=torch.int64, device=device),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32, device=device),
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
        clip_sample=clip_sample,
        prediction_type=prediction_type,
    )


def schedule_from_config(num_inference_steps: int, sched_cfg,
                         kind: Optional[str] = None, device=None
                         ) -> DiffusionSchedule:
    """The schedule a backend's ``SchedulerConfig`` describes."""
    kind = kind or sched_cfg.kind
    return make_schedule(
        num_inference_steps,
        num_train_timesteps=sched_cfg.num_train_timesteps,
        beta_start=sched_cfg.beta_start,
        beta_end=sched_cfg.beta_end,
        schedule=sched_cfg.beta_schedule,
        set_alpha_to_one=sched_cfg.set_alpha_to_one,
        steps_offset=sched_cfg.steps_offset(kind),
        kind=kind,
        clip_sample=sched_cfg.clip_sample,
        prediction_type=sched_cfg.prediction_type,
        device=device,
    )


def _alpha_at(sched: DiffusionSchedule, t: int) -> torch.Tensor:
    """``alphas_cumprod[t]``, with t < 0 mapping to ``final_alpha_cumprod``."""
    t = int(t)
    return sched.alphas_cumprod[t] if t >= 0 else sched.final_alpha_cumprod


def to_epsilon(sched: DiffusionSchedule, model_out: torch.Tensor, t: int,
               sample: torch.Tensor) -> torch.Tensor:
    """The model output as an ε-prediction: v-parameterization gives
    ε = √ā·v + √(1−ā)·x_t."""
    if sched.prediction_type == "epsilon":
        return model_out
    if sched.prediction_type == "v_prediction":
        a_t = _alpha_at(sched, t)
        return (torch.sqrt(a_t) * model_out.float()
                + torch.sqrt(1.0 - a_t) * sample.float()).to(model_out.dtype)
    raise ValueError(f"unknown prediction_type: {sched.prediction_type!r}")


def ddim_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step x_t → x_{t-Δ}, in f32."""
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, int(t) - sched.step_size)
    x = sample.float()
    e = eps.float()
    pred_x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
    if sched.clip_sample:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    direction = torch.sqrt(1.0 - a_prev) * e
    return (torch.sqrt(a_prev) * pred_x0 + direction).to(sample.dtype)


def ddim_next_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
                   sample: torch.Tensor) -> torch.Tensor:
    """One DDIM *inversion* step x_t → x_{t+Δ}, in f32: the closed-form
    ascent null-text inversion records its trajectory with."""
    cur_t = min(int(t) - sched.step_size, sched.num_train_timesteps - 1)
    a_t = _alpha_at(sched, cur_t)
    a_next = _alpha_at(sched, t)
    x = sample.float()
    e = eps.float()
    pred_x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
    direction = torch.sqrt(1.0 - a_next) * e
    return (torch.sqrt(a_next) * pred_x0 + direction).to(sample.dtype)
