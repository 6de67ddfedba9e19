#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the CUDA kernels, holds each
against its plain PyTorch version at every main-path geometry, and drives
the SD-1.4 Replace edit end to end through ``text2image``.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository
checkout around this file; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   ``p2p_tpu_torch/csrc/*.cu`` for ``sm_90a`` (one ``nvcc`` per source, in
   parallel);
2. kernel phases: K1 (flash attention) and K2 (fused edit) against their
   plain versions on the same card inputs, max|Δ| ≤ 1e-4 in f32 with TF32
   off; each timed with CUDA events beside its plain version, its roofline
   bound and (K1) ``scaled_dot_product_attention`` as a yardstick;
3. the main path: random SD-1.4 weights at full width from seed 0, 512²,
   2 prompts, DDIM 50 steps, CFG 7.5, an ``attention_replace`` edit
   (store off) with ``kernels=KernelConfig()``; the launch counts must be
   exactly 5 K1 and 22 K2 per step plus 1 K1 for the VAE, and the final
   latents must agree with the ``kernels=None`` run within 1e-2;
4. one ``{"kernels": [...]}`` line, then the device line last.

Exits non-zero, printing no result, when no CUDA card is visible or the
package is missing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

KERNEL_TOL = 1e-4      # kernel vs plain version, f32, same inputs
DRIFT_TOL = 1e-2       # fused-edit run vs materialized run, final latents
STEPS = 50
PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores (the kernels use
# no TF32) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    if not math.isfinite(d):
        raise RuntimeError("non-finite kernel output")
    return d


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def k1_phases(torch, K, F):
    """K1 at the U-Net 64² self sites and the VAE mid attention."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for shape, iters in (((4, 8, 4096, 40), 20), ((2, 1, 4096, 512), 10)):
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        scale = d ** -0.5
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = max_err(torch, out, K.flash_attention_plain(q, k, v, scale))
        if err > KERNEL_TOL:
            raise RuntimeError(f"K1 {shape}: max|Δ| {err} > {KERNEL_TOL}")
        bound_ms, bound_by = bound(4.0 * b * h * s * s * d, 4 * 4 * q.numel())
        rows.append({
            "shape": list(shape), "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), iters),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters),
            "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K1 {shape}: max|Δ| {err:.3g}  kernel {rows[-1]['ms']:.4f} ms  "
              f"plain {rows[-1]['plain_ms']:.4f} ms  sdpa "
              f"{rows[-1]['library_ms']:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return rows


def k2_phases(torch, K):
    """K2 at every main-path (P, D, Kp): the 16 cross sites (Replace and
    Refine operands) and the 6 self sites inside (α = 1) and outside (α = 0)
    the injection window."""
    from p2p_tpu_torch.controllers.factory import attention_refine, attention_replace
    from p2p_tpu_torch.controllers.kernel_spec import edit_operands, kernel_edit_spec
    from p2p_tpu_torch.models.config import SD14, unet_layout
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    tok = HashWordTokenizer()
    refine_prompts = ["a cat riding a bicycle", "a cat riding a red bicycle"]
    ctrls = {"replace": attention_replace(PROMPTS, STEPS, 0.8, 0.4, tok, store=False),
             "refine": attention_refine(refine_prompts, STEPS, 0.8, 0.4, tok, store=False)}
    metas = {}
    for m in unet_layout(SD14.unet).metas:
        metas.setdefault((m.is_cross, m.pixels), m)
    gen = torch.Generator("cuda").manual_seed(2)
    cases = [(kind, metas[(True, p)], 0) for p in (4096, 1024, 256, 64)
             for kind in ("replace", "refine")]
    cases += [("replace", metas[(False, p)], step) for p in (256, 64) for step in (0, 45)]
    rows = []
    for kind, meta, step in cases:
        ctrl = ctrls[kind]
        edit = ctrl.edit.to("cuda")
        spec = kernel_edit_spec(ctrl, meta)
        ops = {n: t.contiguous() for n, t in edit_operands(edit, spec, step).items()}
        d = meta.channels // meta.heads
        q = torch.randn((4, meta.heads, meta.pixels, d), generator=gen, device="cuda")
        k, v = (torch.randn((4, meta.heads, meta.key_len, d), generator=gen,
                            device="cuda") for _ in range(2))
        scale = d ** -0.5
        out = K.edit_attention(q, k, v, scale, spec, ops)
        torch.cuda.synchronize()
        err = max_err(torch, out, K.edit_attention_plain(q, k, v, scale, spec, ops))
        label = (f"{'cross' if meta.is_cross else 'self'} {kind} P={meta.pixels} "
                 f"D={d} K={meta.key_len} Kp={spec.pad_len} step={step}")
        if err > KERNEL_TOL:
            raise RuntimeError(f"K2 {label}: max|Δ| {err} > {KERNEL_TOL}")
        # Work this run's operands need: 3 plain rows (QK and PV), and the
        # edit row's own softmax unless α ≡ 1 without transform, its base
        # softmax unless α ≡ 0, its K x K transform, and its PV.
        alpha = ops["blend"][:, :meta.key_len]
        zero, one = bool((alpha == 0).all()), bool((alpha == 1).all())
        qk = 2.0 * meta.pixels * meta.key_len * d
        edit_row = (0 if one and not spec.has_transform else qk) + qk
        if not zero:
            edit_row += qk + (2.0 * meta.pixels * meta.key_len ** 2
                              if spec.has_transform else 0)
        flops = meta.heads * (3 * 2 * qk + edit_row)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel() + sum(t.numel() for t in ops.values()))
        bound_ms, bound_by = bound(flops, nbytes)
        iters = 20 if meta.pixels >= 1024 else 50
        rows.append({
            "site": label, "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.edit_attention(q, k, v, scale, spec, ops), iters),
            "plain_ms": cuda_ms(torch, lambda: K.edit_attention_plain(
                q, k, v, scale, spec, ops), 5),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K2 {label}: max|Δ| {err:.3g}  kernel {rows[-1]['ms']:.4f} ms  "
              f"plain {rows[-1]['plain_ms']:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return rows


def main_path(torch, K):
    from p2p_tpu_torch import KernelConfig, attention_replace, random_pipeline, text2image
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models.config import SD14, unet_layout
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    tok = HashWordTokenizer()
    t0 = time.perf_counter()
    pipe = random_pipeline(SD14, tok, "cuda", seed=0)
    ctrl = attention_replace(PROMPTS, STEPS, 0.8, 0.4, tok, store=False)
    torch.cuda.synchronize()
    print(f"main path: SD-1.4 random weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    variants = [site_variant(KernelConfig(), ctrl, m) for m in unet_layout(SD14.unet).metas]
    n_k2 = variants.count("fused-edit")
    n_k1 = sum(1 for v, m in zip(variants, unet_layout(SD14.unet).metas)
               if v == "flash" and m.pixels >= 2048)
    if (n_k2, n_k1) != (22, 5):
        raise RuntimeError(f"dispatch: {n_k2} fused-edit and {n_k1} K1 sites, "
                           "expected 22 and 5")
    x_t = torch.randn((1, 64, 64, 4), generator=torch.Generator("cuda").manual_seed(8191),
                      device="cuda")

    def run(kernels):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, PROMPTS, ctrl, num_steps=STEPS,
                                    latent=x_t, kernels=kernels, device="cuda",
                                    return_latents=True)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    run(KernelConfig())                      # warm-up: cuDNN and allocator
    K.reset_launch_counts()
    img, lat, secs = run(KernelConfig())
    counts = K.launch_counts()
    want = {"flash_attn": STEPS * 5 + 1, "fused_edit": STEPS * 22}
    if counts != want:
        raise RuntimeError(f"launch counts {counts}, expected {want}")
    if img.shape != (2, 512, 512, 3) or img.dtype != torch.uint8:
        raise RuntimeError(f"images {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(lat).all()):
        raise RuntimeError("non-finite latents")
    img_ref, lat_ref, secs_ref = run(None)
    drift = max_err(torch, lat, lat_ref)
    if drift > DRIFT_TOL:
        raise RuntimeError(f"fused-edit latents drift {drift} > {DRIFT_TOL}")
    pix = (img.short() - img_ref.short()).abs().float()
    print(f"main path: launches {counts}; latents max|Δ| vs kernels=None {drift:.3g}; "
          f"image max|Δ| {pix.max().item():.0f} mean {pix.mean().item():.4f}")
    print(f"main path: {secs:.3f} s per image pair with kernels "
          f"({secs / STEPS * 1e3:.2f} ms per step, VAE and text encoder "
          f"included), {secs_ref:.3f} s with kernels=None")
    return counts, {"s_per_pair": secs, "s_per_pair_materialized": secs_ref,
                    "latent_drift": drift}


def kernel_entry(name, source, replaces, launches, rows):
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "geometries": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from p2p_tpu_torch import kernels as K
    from p2p_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, r in sorted(report.items()):
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    k1 = k1_phases(torch, K, F)
    k2 = k2_phases(torch, K)
    counts, path = main_path(torch, K)
    result = {"kernels": [
        kernel_entry("flash_attn", "p2p_tpu_torch/csrc/flash_attn.cu",
                     "p2p_tpu/models/nn.py:330", counts["flash_attn"], k1),
        kernel_entry("fused_edit", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", counts["fused_edit"], k2),
    ], "main_path": path, "card": card}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
