"""Where a step's time goes on the card: a sampling step of the SD-1.4
Replace edit, or an inner iteration of null-text inversion.

    python -m p2p_tpu_torch.profile_step               # sampling step
    python -m p2p_tpu_torch.profile_step --inversion   # inner iteration

Random SD-1.4 weights (seed 0), 512², CFG 7.5.

The sampling step: 2 prompts, the ``attention_replace`` edit with the store
off — the ``chip_smoke.py`` main path. Two measurements:

1. ms per denoising step over 10 steps (text encoder and VAE excluded) with
   ``kernels=KernelConfig()`` and with ``kernels=None``, timed with CUDA
   events in the order kernels, none, none, kernels;
2. a ``torch.profiler`` trace of 3 steps of the kernel
   path: device time by kernel class (convolution, matrix product, K1, K2,
   other) and the device's idle share of the traced window.

The inner iteration (``--inversion``): one gradient of the null-text loss
with respect to the uncond embedding at the first outer step — a batch-1
U-Net forward and backward, K1 at one 64² self site, K3 and K4 at four —
and the loss read back to the host, as ``engine.inversion.null_optimize``
runs it. ms per inner iteration over 10 iterations (CUDA events), then a
trace of 3 with the same breakdown (K1 and K3 are one CUDA kernel and
share a class).

Prints one JSON object as its last line and writes it to
``chiprun_out/profile_step.json`` (``profile_inner.json`` with
``--inversion``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from .controllers.factory import attention_replace
from .engine.sampler import denoise, encode_prompts, random_pipeline, resolve_device
from .kernels.dispatch import KernelConfig
from .models.config import SD14
from .utils.tokenizer import HashWordTokenizer

PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]
STEPS = 10           # timed steps per run
PROFILE_STEPS = 3    # traced steps

# Kernel-name fragments of each class, first match wins.
CLASSES = (
    ("K1/K3 flash_attn", ("flash_fwd_kernel", "flash_d512_kernel", "flash_merge_kernel")),
    ("K4 flash_attn_bwd dkv", ("flash_bwd_dkv_kernel",)),
    ("K4 flash_attn_bwd dq", ("flash_bwd_dq_kernel",)),
    ("K2 fused_edit", ("fused_edit_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                     "xmma_fprop")),
    ("matrix product", ("gemm", "gemv", "cutlass", "ampere_s", "sm90_xmma", "magma")),
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


def _sampling_step(pipe, device, tok) -> dict:
    ctrl = attention_replace(PROMPTS, 50, 0.8, 0.4, tok, store=False).to(device)
    with torch.no_grad():
        context = torch.cat([encode_prompts(pipe, ["", ""]),
                             encode_prompts(pipe, PROMPTS)])
    x = torch.randn((len(PROMPTS),) + pipe.latent_shape,
                    generator=torch.Generator(device).manual_seed(1), device=device)

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


def _inner_iteration(pipe, device) -> dict:
    from .engine.inversion import null_text_loss
    from .models.unet import apply_unet
    from .ops.schedulers import schedule_from_config

    sched = schedule_from_config(50, pipe.config.scheduler, kind="ddim", device=device)
    t = sched.timesteps.tolist()[0]
    gen = torch.Generator(device).manual_seed(1)
    latent, target = (torch.randn((1,) + pipe.latent_shape, generator=gen,
                                  device=device) for _ in range(2))
    with torch.no_grad():
        cond = encode_prompts(pipe, [PROMPTS[0]])
        u0 = encode_prompts(pipe, [""])
        eps_cond, _ = apply_unet(pipe.unet, pipe.config.unet, latent, t, cond)

    def run(iters):
        for _ in range(iters):
            u = u0.detach().requires_grad_(True)
            loss = null_text_loss(pipe, sched, latent, t, u, eps_cond, target, 7.5)
            torch.autograd.grad(loss, u)
            loss.item()

    run(2)                                        # warm-up: cuDNN, allocator
    return {"ms_per_inner_iteration": _cuda_ms(lambda: run(STEPS), STEPS),
            **_breakdown(lambda: run(PROFILE_STEPS), PROFILE_STEPS)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m p2p_tpu_torch.profile_step")
    p.add_argument("--inversion", action="store_true",
                   help="profile a null-text inner iteration instead of a "
                        "sampling step")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    tok = HashWordTokenizer()
    pipe = random_pipeline(SD14, tok, device, seed=0)
    result = _inner_iteration(pipe, device) if args.inversion else \
        _sampling_step(pipe, device, tok)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    name = "profile_inner.json" if args.inversion else "profile_step.json"
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
