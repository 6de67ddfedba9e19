"""Where a sampling step's time goes on the card, for the SD-1.4 Replace edit.

    python -m p2p_tpu_torch.profile_step

Random SD-1.4 weights (seed 0), 512², 2 prompts, CFG 7.5, the
``attention_replace`` edit with the store off — the ``chip_smoke.py`` main
path. Two measurements:

1. ms per denoising step over 10 steps (text encoder and VAE excluded) with
   ``kernels=KernelConfig()`` and with ``kernels=None``, timed with CUDA
   events in the order kernels, none, none, kernels;
2. a ``torch.profiler`` trace of 3 steps of the kernel
   path: device time by kernel class (convolution, matrix product, K1, K2,
   other) and the device's idle share of the traced window.

Prints one JSON object as its last line and writes it to
``chiprun_out/profile_step.json``. Needs a CUDA card.
"""

from __future__ import annotations

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
    ("K1 flash_attn", ("flash_fwd_kernel",)),
    ("K2 fused_edit", ("fused_edit_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd", "xmma_fprop")),
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


def main() -> dict:
    device = resolve_device("cuda")
    tok = HashWordTokenizer()
    pipe = random_pipeline(SD14, tok, device, seed=0)
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

    def step_ms(kernels) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        run(kernels, STEPS)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / STEPS

    run(KernelConfig(), 2)                       # warm-up: cuDNN, allocator
    run(None, 2)
    order = [("kernels", KernelConfig()), ("none", None), ("none", None),
             ("kernels", KernelConfig())]
    times = {"kernels": [], "none": []}
    for label, kc in order:
        times[label].append(step_ms(kc))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        run(KernelConfig(), PROFILE_STEPS)
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
    n_kernels = len(seen)
    device_us = sum(by_class.values())
    busy_us = _merged_busy_us(intervals)
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {
        "card": card,
        "ms_per_step": {k: v for k, v in times.items()},
        "profile_steps": PROFILE_STEPS,
        "device_ms_per_step_by_class": {
            k: v / 1e3 / PROFILE_STEPS
            for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "device_share_by_class": {k: v / device_us for k, v in by_class.items()}
        if device_us else {},
        "device_kernels_per_step": n_kernels / PROFILE_STEPS,
        "traced_wall_ms_per_step": wall_us / 1e3 / PROFILE_STEPS,
        "idle_share": 1.0 - busy_us / wall_us if device_us else None,
        "device_busy_ms_per_step": busy_us / 1e3 / PROFILE_STEPS,
        "top_kernels_ms_per_step": {
            k[:120]: v / 1e3 / PROFILE_STEPS
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    if not device_us:
        print("profile_step: the profiler recorded no device events")
    for label, ms in result["device_ms_per_step_by_class"].items():
        print(f"{label:>24}: {ms:9.3f} ms/step")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_step.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
