"""Diffusion schedulers — the PyTorch counterpart of
``p2p_tpu/ops/schedulers.py``.

A :class:`DiffusionSchedule` holds the precomputed constants (computed in
float64 with numpy, stored as f32 as the JAX package stores them); the step
math runs in f32 on the carry's dtype, with the timestep a Python int:

- **DDIM** (η = 0): :func:`ddim_step` samples, :func:`ddim_next_step`
  inverts (null-text inversion). ``set_alpha_to_one=False`` semantics: the
  final step uses ``alphas_cumprod[0]``, not 1.
- **PLMS** (PNDM with the Runge–Kutta steps skipped): T + 1 timesteps with
  the second repeated (a 50-step run makes 51 U-Net calls); :func:`plms_step`
  carries a ring of the last four ε's (:class:`PlmsState`).
- **DPM-Solver++(2M)**: :func:`dpm_step`, second order from the second step,
  carrying the previous x0 prediction (:class:`DpmState`).
- **DDPM** (ancestral, ``fixed_small`` variance): :func:`ddpm_step`, and the
  forward corruption :func:`add_noise`.

The multistep states are made in the carry's dtype
(:func:`init_multistep_state`) and keep it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    timesteps: torch.Tensor              # (num_iters,) int64, descending
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
    """``kind='ddim'`` / ``'dpm'``: T timesteps ``[(T-1)·s, ..., 0] +
    offset``. ``kind='plms'``: T + 1 timesteps with the second one repeated,
    the warm-up re-evaluation of the first step that PLMS builds its
    history with."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, schedule)
    acp = np.cumprod(1.0 - betas)
    step = num_train_timesteps // num_inference_steps
    base = (np.arange(num_inference_steps) * step).round().astype(np.int64) + steps_offset
    if kind in ("ddim", "dpm"):
        ts = base[::-1].copy()
    elif kind == "plms":
        ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
    else:
        raise ValueError(f"unknown schedule kind: {kind!r}")
    final = acp[0] if not set_alpha_to_one else 1.0
    return DiffusionSchedule(
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32, device=device),
        timesteps=torch.tensor(ts, dtype=torch.int64, device=device),
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


# ---------------------------------------------------------------------------
# PLMS (pseudo linear multistep; PNDM with the Runge–Kutta steps skipped)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlmsState:
    """PLMS's history: the last four ε's, newest first, the evaluation
    counter, and the sample saved at the first evaluation for the warm-up
    re-evaluation."""

    ets: Tuple[torch.Tensor, ...]
    counter: int
    cur_sample: torch.Tensor


def init_plms_state(sample_shape, dtype=torch.float32, device=None) -> PlmsState:
    zeros = torch.zeros(sample_shape, dtype=dtype, device=device)
    return PlmsState(ets=(zeros,) * 4, counter=0, cur_sample=zeros)


def _plms_prev_sample(sched, sample, t, prev_t, eps):
    """The PNDM transfer φ(x, t, t−Δ, ε) (Liu et al., eq. 11), in f32."""
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, prev_t)
    b_t = 1.0 - a_t
    b_prev = 1.0 - a_prev
    sample_coeff = torch.sqrt(a_prev / a_t)
    denom = a_t * torch.sqrt(b_prev) + torch.sqrt(a_t * b_t * a_prev)
    out = sample_coeff * sample.float() - (a_prev - a_t) * eps.float() / denom
    return out.to(sample.dtype)


def plms_step(sched: DiffusionSchedule, state: PlmsState, eps: torch.Tensor,
              t: int, sample: torch.Tensor) -> Tuple[PlmsState, torch.Tensor]:
    """One PLMS step. The evaluation counter c picks the ε combination
    (Adams–Bashforth orders 1 to 4): c = 0 the raw ε (the sample saved for
    the re-evaluation), c = 1 its average with the stored ε, stepping again
    from the same timestep, c = 2, 3, ≥ 4 the 2nd-, 3rd- and 4th-order
    combinations, of ε and the ring promoted to a common dtype (f32 for
    CFG's f32 ε) as the JAX package combines them. The ring takes ε at every evaluation but the
    second, in the state's dtype: the JAX package's step hands back an f32
    ring for a bf16 state (its scan over a bf16 carry then refuses it)."""
    c = state.counter
    e1, e2, e3, _ = state.ets
    if c == 1:
        prev_t, t_eff, ets = int(t), int(t) + sched.step_size, state.ets
        eps_used = (eps + e1) / 2.0
    else:
        prev_t, t_eff = int(t) - sched.step_size, int(t)
        ets = tuple(e.to(e1.dtype) for e in (eps, e1, e2, e3))
        dt = torch.promote_types(eps.dtype, e1.dtype)
        n1, n2, n3, n4 = (e.to(dt) for e in (eps, e1, e2, e3))
        eps_used = (n1 if c == 0 else
                    (3.0 * n1 - n2) / 2.0 if c == 2 else
                    (23.0 * n1 - 16.0 * n2 + 5.0 * n3) / 12.0 if c == 3 else
                    (55.0 * n1 - 59.0 * n2 + 37.0 * n3 - 9.0 * n4) / 24.0)
    sample_used = state.cur_sample if c == 1 else sample
    cur = sample.to(state.cur_sample.dtype) if c == 0 else state.cur_sample
    prev = _plms_prev_sample(sched, sample_used, t_eff, prev_t, eps_used)
    return PlmsState(ets=ets, counter=c + 1, cur_sample=cur), prev


# ---------------------------------------------------------------------------
# DPM-Solver++(2M) (Lu et al., arXiv 2211.01095): deterministic, the data
# prediction, second order from the second step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DpmState:
    """DPM-Solver++'s history: the previous x0 prediction, its log-SNR λ,
    and whether a previous step exists (the order ramps from 1 to 2)."""

    x0_prev: torch.Tensor
    lam_prev: torch.Tensor      # f32 scalar
    has_prev: bool


def init_dpm_state(sample_shape, dtype=torch.float32, device=None) -> DpmState:
    return DpmState(x0_prev=torch.zeros(sample_shape, dtype=dtype, device=device),
                    lam_prev=torch.zeros((), dtype=torch.float32, device=device),
                    has_prev=False)


def dpm_step(sched: DiffusionSchedule, state: DpmState, eps: torch.Tensor,
             t: int, sample: torch.Tensor) -> Tuple[DpmState, torch.Tensor]:
    """One DPM-Solver++(2M) step x_t → x_{t−Δ}, in f32: with α = √ā,
    σ = √(1 − ā), λ = log(α/σ) and h = λ_next − λ_t,
    x_next = (σ_next/σ_t)·x − α_next·(e^{−h} − 1)·D, where D is x0 on the
    first and the final step (t − Δ < 0) and otherwise
    (1 + 1/2r)·x0 − 1/(2r)·x0_prev with r = h_prev/h."""
    prev_t = int(t) - sched.step_size
    a_t = _alpha_at(sched, t)
    a_next = _alpha_at(sched, prev_t)
    x = sample.float()
    e = eps.float()
    alpha_t, sigma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    alpha_n, sigma_n = torch.sqrt(a_next), torch.sqrt(1.0 - a_next)
    lam_t = torch.log(alpha_t / sigma_t)
    h = torch.log(alpha_n / sigma_n) - lam_t
    x0 = (x - sigma_t * e) / alpha_t
    if sched.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    d = x0
    if state.has_prev and prev_t >= 0:
        r = (lam_t - state.lam_prev) / h
        d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.x0_prev.float()
    x_next = (sigma_n / sigma_t) * x - alpha_n * torch.expm1(-h) * d
    return (DpmState(x0_prev=x0.to(state.x0_prev.dtype), lam_prev=lam_t,
                     has_prev=True),
            x_next.to(sample.dtype))


def init_multistep_state(kind: str, sample_shape, dtype=torch.float32,
                         device=None):
    """The multistep state of scheduler ``kind`` in ``dtype`` (None for the
    single-step DDIM)."""
    if kind == "plms":
        return init_plms_state(sample_shape, dtype, device)
    if kind == "dpm":
        return init_dpm_state(sample_shape, dtype, device)
    if kind == "ddim":
        return None
    raise ValueError(f"unknown scheduler kind: {kind!r}")


def multistep_step(sched: DiffusionSchedule, kind: str, state, eps: torch.Tensor,
                   t: int, sample: torch.Tensor):
    """``(state, x_{t−Δ})``: one step of scheduler ``kind`` with its
    multistep state (:func:`init_multistep_state`)."""
    if kind == "plms":
        return plms_step(sched, state, eps, t, sample)
    if kind == "dpm":
        return dpm_step(sched, state, eps, t, sample)
    return state, ddim_step(sched, eps, t, sample)


# ---------------------------------------------------------------------------
# DDPM (ancestral) and the forward corruption
# ---------------------------------------------------------------------------


def ddpm_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
              sample: torch.Tensor, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ancestral DDPM step with the ``fixed_small`` posterior variance,
    in f32. ``noise`` (f32, ``sample``'s shape) is the step's standard
    normal draw; without it one is drawn from ``generator``. The final step
    (t − Δ < 0) takes the mean."""
    prev_t = int(t) - sched.step_size
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, prev_t)
    alpha_ratio = a_t / a_prev
    beta_t = 1.0 - alpha_ratio
    x = sample.float()
    e = eps.float()
    pred_x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
    x0_coeff = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
    xt_coeff = torch.sqrt(alpha_ratio) * (1.0 - a_prev) / (1.0 - a_t)
    out = x0_coeff * pred_x0 + xt_coeff * x
    if prev_t >= 0:
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator,
                                dtype=torch.float32, device=sample.device)
        var = beta_t * (1.0 - a_prev) / (1.0 - a_t)
        out = out + torch.sqrt(torch.clamp(var, min=0.0)) * noise
    return out.to(sample.dtype)


def add_noise(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    """The forward corruption q(x_t | x_0): ``t`` an int, or an integer
    tensor of per-sample timesteps over ``x0``'s leading dimensions."""
    if isinstance(t, int):
        a_t = _alpha_at(sched, t)
    else:
        t = torch.as_tensor(t, device=sched.alphas_cumprod.device)
        a_t = torch.where(t >= 0, sched.alphas_cumprod[
            t.clamp(0, sched.num_train_timesteps - 1)], sched.final_alpha_cumprod)
        a_t = a_t.reshape(a_t.shape + (1,) * (x0.dim() - a_t.dim()))
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise
