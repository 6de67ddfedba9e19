"""Where a step's time goes on the card: a sampling step of the SD-1.4
Replace edit, or an inner iteration of null-text inversion.

    python -m p2p_tpu_torch.profile_step               # sampling step
    python -m p2p_tpu_torch.profile_step --dtype bf16  # ... in bf16
    python -m p2p_tpu_torch.profile_step --preset sd21 # ... of SD-2.1 768-v
    python -m p2p_tpu_torch.profile_step --inversion   # inner iteration
    python -m p2p_tpu_torch.profile_step --inversion --dtype bf16
    python -m p2p_tpu_torch.profile_step --inversion --preset sd21 [--dtype bf16]

Random weights (seed 0) of the preset (SD-1.4 at 512² by default, ``sd21``
at 768² or ``sd21base``), CFG 7.5.

The sampling step: 2 prompts, the ``attention_replace`` edit with the store
off — the ``chip_smoke.py`` main path — in f32 or, with ``--dtype bf16``,
in bf16 (the text encoder and U-Net in bf16, K1 at d = 40 and K2 as their
bf16 kernels). Two measurements:

1. ms per denoising step over 10 steps (text encoder and VAE excluded) with
   ``kernels=KernelConfig()`` and with ``kernels=None``, timed with CUDA
   events in the order kernels, none, none, kernels;
2. a ``torch.profiler`` trace of 3 steps of the kernel
   path: device time by kernel class (convolution, matrix product, K1, K2,
   other) and the device's idle share of the traced window.

The inner iteration (``--inversion``): one gradient of the null-text loss
with respect to the uncond embedding at the first outer step — a batch-1
U-Net forward and backward, K1 at the self site of 2048 pixels or more
before the first cross site, K3 and K4 at the others (SD-1.4: 1 and 4 at
64², d = 40; SD-2.1 768-v: 1 and 9 at 96² and 48², d = 64) — and the
loss read back to the host, as ``engine.inversion.null_optimize``
runs it, in f32 or, with ``--dtype bf16``, in bf16 (the U-Net, the latent
and the conditional ε in bf16, the embedding f32 and cast at the call; K1,
K3 and K4 as their bf16 kernels). ms per inner iteration over 10
iterations (CUDA events); in bf16 also with the norms' backward summed by
autograd in f32 instead of in the JAX program's windowed bf16 sums
(``kernels/reduce.py``), in the order windowed, f32, f32, windowed; then a
trace of 3 with the same breakdown (K1 and K3 are one CUDA kernel and
share a class).

Prints one JSON object as its last line and writes it to
``chiprun_out/profile_step.json`` (``profile_step_bf16.json`` with
``--dtype bf16``, ``profile_inner.json`` with ``--inversion``,
``profile_inner_bf16.json`` with both; a preset other than sd14 adds its
name, ``profile_step_sd21_bf16.json``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from .controllers.factory import attention_replace
from .engine.inversion import require_k4
from .engine.sampler import denoise, encode_prompts, random_pipeline, resolve_device
from .kernels.dispatch import KernelConfig
from .models.config import PRESET_CONFIGS
from .utils.tokenizer import HashWordTokenizer

PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]
STEPS = 10           # timed steps per run
PROFILE_STEPS = 3    # traced steps

# Kernel-name fragments of each class, first match wins.
CLASSES = (
    ("K1/K3 flash_attn", ("flash_d40_kernel", "flash_d40_bf16_kernel", "flash_d64_kernel",
                          "flash_d64_sm90_kernel", "flash_fwd_kernel",
                          "flash_d512_kernel", "flash_d512_sm90_kernel",
                          "flash_merge_kernel")),
    ("K4 flash_attn_bwd dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel",
                               "flash_bwd_dkv_tf32_sm90_kernel")),
    ("K4 flash_attn_bwd dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel",
                              "flash_bwd_dq_tf32_sm90_kernel")),
    ("K2 fused_edit", ("edit_attn_kernel", "edit_attn_bf16_kernel", "fold_kernel")),
    ("norms' backward sums", ("window_sum_bf16_kernel", "window_sum_block_bf16_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                     "xmma_fprop")),
    ("matrix product", ("gemm", "gemv", "cutlass", "ampere_s", "sm90_xmma", "magma",
                        "nvjet")),
    ("normalization", ("norm", "welford")),
    ("softmax", ("softmax",)),
)


def _class(name: str) -> str:
    low = name.lower()
    for label, frags in CLASSES:
        if any(f in low for f in frags):
            return label
    return "elementwise and other"


def _merged_busy_us(intervals) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _breakdown(fn, steps: int) -> dict:
    """A ``torch.profiler`` trace of ``fn()`` (``steps`` steps of work):
    device time per step by kernel class and by kernel, and the device's
    idle share of the traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict = {}
    by_name: dict = {}
    seen = set()
    for ev in prof.events():
        key = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type != torch.autograd.DeviceType.CUDA or key in seen:
            continue
        seen.add(key)
        dur = ev.time_range.end - ev.time_range.start
        by_class[_class(ev.name)] = by_class.get(_class(ev.name), 0.0) + dur
        by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    intervals = [(s, e) for _, s, e in seen]
    device_us = sum(by_class.values())
    busy_us = _merged_busy_us(intervals)
    if not device_us:
        print("profile_step: the profiler recorded no device events")
    result = {
        "profile_steps": steps,
        "device_ms_per_step_by_class": {
            k: v / 1e3 / steps
            for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "device_share_by_class": {k: v / device_us for k, v in by_class.items()}
        if device_us else {},
        "device_kernels_per_step": len(seen) / steps,
        "traced_wall_ms_per_step": wall_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / wall_us if device_us else None,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "top_kernels_ms_per_step": {
            k[:120]: v / 1e3 / steps
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    for label, ms in result["device_ms_per_step_by_class"].items():
        print(f"{label:>24}: {ms:9.3f} ms/step")
    return result


def _cuda_ms(fn, count: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def _sampling_step(pipe, device, tok, dtype) -> dict:
    ctrl = attention_replace(PROMPTS, 50, 0.8, 0.4, tok, store=False).to(device)
    with torch.no_grad():
        context = torch.cat([encode_prompts(pipe, ["", ""], dtype),
                             encode_prompts(pipe, PROMPTS, dtype)])
    x = torch.randn((len(PROMPTS),) + pipe.latent_shape,
                    generator=torch.Generator(device).manual_seed(1),
                    device=device).to(dtype)

    def run(kernels, steps):
        with torch.no_grad():
            return denoise(pipe, context, x, ctrl, num_steps=steps,
                           guidance_scale=7.5, kernels=kernels)

    run(KernelConfig(), 2)                       # warm-up: cuDNN, allocator
    run(None, 2)
    order = [("kernels", KernelConfig()), ("none", None), ("none", None),
             ("kernels", KernelConfig())]
    times = {"kernels": [], "none": []}
    for label, kc in order:
        times[label].append(_cuda_ms(lambda: run(kc, STEPS), STEPS))
    return {"ms_per_step": times,
            **_breakdown(lambda: run(KernelConfig(), PROFILE_STEPS), PROFILE_STEPS)}


def _inner_iteration(pipe, device, dtype) -> dict:
    from .engine.inversion import null_text_loss
    from .models import nn
    from .models.unet import apply_unet
    from .ops.schedulers import schedule_from_config

    sched = schedule_from_config(50, pipe.config.scheduler, kind="ddim", device=device)
    t = sched.timesteps.tolist()[0]
    gen = torch.Generator(device).manual_seed(1)
    latent, target = (torch.randn((1,) + pipe.latent_shape, generator=gen,
                                  device=device).to(dtype) for _ in range(2))
    with torch.no_grad():
        cond = encode_prompts(pipe, [PROMPTS[0]], dtype)
        u0 = encode_prompts(pipe, [""], dtype).float()
        eps_cond, _ = apply_unet(pipe.weights(dtype)[0], pipe.config.unet, latent, t, cond)

    def run(iters):
        for _ in range(iters):
            u = u0.detach().requires_grad_(True)
            loss = null_text_loss(pipe, sched, latent, t, u, eps_cond, target, 7.5)
            torch.autograd.grad(loss, u)
            loss.item()

    run(2)                                        # warm-up: cuDNN, allocator
    result = {"ms_per_inner_iteration": _cuda_ms(lambda: run(STEPS), STEPS)}
    if dtype != torch.float32:
        # What summing the norms' backward as the JAX program does costs:
        # the iteration again with autograd's own f32 sums.
        windowed, times = nn._broadcast, {"windowed": [], "f32": []}
        try:
            for label in ("windowed", "f32", "f32", "windowed"):
                nn._broadcast = windowed if label == "windowed" else \
                    (lambda a, shape, order=None: a)
                run(1)
                times[label].append(_cuda_ms(lambda: run(STEPS), STEPS))
        finally:
            nn._broadcast = windowed
        result["ms_per_inner_iteration_by_norm_sums"] = times
    return {**result, **_breakdown(lambda: run(PROFILE_STEPS), PROFILE_STEPS)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m p2p_tpu_torch.profile_step")
    p.add_argument("--inversion", action="store_true",
                   help="profile a null-text inner iteration instead of a "
                        "sampling step")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                   help="compute dtype of the sampling step or inner iteration")
    p.add_argument("--preset", choices=("sd14", "sd21", "sd21base"), default="sd14")
    args = p.parse_args(argv)
    if args.inversion:
        try:
            require_k4(PRESET_CONFIGS[args.preset], f"--inversion --preset {args.preset}")
        except NotImplementedError as e:
            p.error(str(e))
    device = resolve_device("cuda")
    tok = HashWordTokenizer()
    pipe = random_pipeline(PRESET_CONFIGS[args.preset], tok, device, seed=0)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    result = _inner_iteration(pipe, device, dtype) if args.inversion else \
        _sampling_step(pipe, device, tok, dtype)
    result["dtype"] = args.dtype
    result["preset"] = args.preset
    result["card"] = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    name = (f"profile_{'inner' if args.inversion else 'step'}"
            f"{'' if args.preset == 'sd14' else '_' + args.preset}"
            f"{'_bf16' if args.dtype == 'bf16' else ''}.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
