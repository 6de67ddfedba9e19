#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the CUDA kernels, holds each
against its plain PyTorch version at every geometry its paths give it, and
drives the SD-1.4 Replace edit, a null-text inversion and its replay edit end
to end through the package's entry points.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository
checkout around this file; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   ``p2p_tpu_torch/csrc/*.cu`` for ``sm_90a`` (one ``nvcc`` per source, in
   parallel);
2. kernel phases: K1 (flash attention), K2 (fused edit), K3 (flash
   forward with residuals) and K4 (flash backward, a dk/dv and a dq pass)
   against their plain versions on the same card inputs, max|Δ| ≤ 1e-4 in
   f32 with TF32 off for the kernels on the CUDA cores and ≤ 1e-5 for
   those on the tensor cores in 3xTF32 (K1 and K3 at d = 512, K4; K3/K4
   relative to the plain output's largest magnitude), K1 at d = 512 also
   at ragged lengths; K1 at d = 512 and both K4 passes give bitwise-equal
   outputs from two launches; each timed with CUDA events beside its plain
   version, its roofline bound on the units it runs on (``bound_ms``; both
   the f32 CUDA-core and the 3xTF32 tensor-core figures beside it) and,
   where one exists, a PyTorch call computing the same function
   (``scaled_dot_product_attention`` forward, or its backward);
3. the main path: random SD-1.4 weights at full width from seed 0, 512²,
   2 prompts, DDIM 50 steps, CFG 7.5, an ``attention_replace`` edit
   (store off) with ``kernels=KernelConfig()``; the launch counts must be
   exactly 5 K1 and 22 K2 per step plus 1 K1 for the VAE, and the final
   latents must agree with the ``kernels=None`` run within 1e-2;
4. the inversion path: ``invert`` of a seeded 512² image at the reference
   defaults (50 steps, 10 inner steps, early stop 1e-5, CFG 7.5); the
   launch counts must be exactly what the layout and the inner-iteration
   counts give (see ``inversion_path``), K1's key-split merge once per
   d = 512 call that splits its keys on this card, and every embedding
   finite;
5. the replay edit of that artifact (Replace + LocalBlend + Reweight) with
   ``kernels=KernelConfig()`` (exact K1/K2 counts), with ``kernels=None``
   (latents within 1e-2) and with the raw ``""`` uncond: the source row must
   end closer to the encoded image's latent with the optimized embeddings;
6. one ``{"kernels": [...]}`` line, then the device line last.

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
# The same for the kernels on the tensor cores in 3xTF32 (K1 and K3 at
# d = 512, K4): they keep f32 accuracy, and this limit fails one TF32 pass
# (tests/test_torch_tf32.py) or one f32 accumulator over a 4096-long sum.
TC_TOL = 1e-5
DRIFT_TOL = 1e-2       # fused-edit run vs materialized run, final latents
STEPS = 50
PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]
INNER_STEPS = 10       # null-text inner iterations per outer step
EARLY_STOP = 1e-5      # null-text early-stop threshold
IMAGE_SEED = 0         # the inverted image, uint8 noise from numpy
BLEND_WORDS = (("cat",), ("dog",))
EQUALIZER = {"words": ("dog",), "values": (2.0,)}

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, TF32 on the
# tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, tensor_cores: bool) -> dict:
    """The least time for ``flops`` f32 operations and ``nbytes`` of memory
    traffic on the units the kernel runs them on (``bound_ms``, with what
    bounds it): the tensor cores in 3xTF32, three TF32 products per
    product, when ``tensor_cores``, else the CUDA cores in f32. Both
    figures stand beside it (``bound_3xtf32_ms``, ``bound_f32_ms``)."""
    t_bytes = nbytes / PEAK_BYTES
    t_f32, t_tc = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS
    t_ops = t_tc if tensor_cores else t_f32
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_on": "tensor cores, 3xTF32" if tensor_cores else "CUDA cores, f32",
            "bound_f32_ms": max(t_f32, t_bytes) * 1e3,
            "bound_3xtf32_ms": max(t_tc, t_bytes) * 1e3}


def bound_text(r: dict) -> str:
    return (f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_on']}); "
            f"f32 {r['bound_f32_ms']:.4f}, 3xTF32 {r['bound_3xtf32_ms']:.4f} ms")


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


def path_counts(K) -> dict:
    """Every wrapper's launch count, and K1's key-split merges."""
    return {**K.launch_counts(), "flash_merge": K.merge_launches()}


def vae_merges(torch, pipe, batch: int) -> int:
    """Merge launches of one K1 call at the VAE's mid attention, d = 512:
    1 when the card's SM count makes the call split its keys, else 0."""
    from p2p_tpu_torch.kernels.flash import D512_TILE, key_splits

    tiles = -(-pipe.config.latent_size ** 2 // D512_TILE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int(key_splits(tiles * batch, tiles, sms) > 1)


def k1_phases(torch, K, F):
    """K1 at the U-Net 64² self sites and the VAE mid attention: batch 4 and
    2 on the edit paths, batch 1 in the inversion (its forwards without
    gradient, and the VAE encode); then the d = 512 kernel at ragged
    lengths (S = 4100, and Sq = 300 with Sk = 70), with K3's residuals, and
    twice at the path shape for bitwise-equal outputs."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for shape, iters in (((4, 8, 4096, 40), 20), ((2, 1, 4096, 512), 10),
                         ((1, 8, 4096, 40), 20), ((1, 1, 4096, 512), 10)):
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        scale = d ** -0.5
        tol = TC_TOL if d == 512 else KERNEL_TOL
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = max_err(torch, out, K.flash_attention_plain(q, k, v, scale))
        if err > tol:
            raise RuntimeError(f"K1 {shape}: max|Δ| {err} > {tol}")
        if d == 512 and not torch.equal(out, K.flash_attention(q, k, v, scale)):
            raise RuntimeError(f"K1 {shape}: two launches differ")
        rows.append({
            "shape": list(shape), "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), iters),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters),
            **bound(4.0 * b * h * s * s * d, 4 * 4 * q.numel(), d == 512)})
        print(f"K1 {shape}: max|Δ| {err:.3g}  kernel {rows[-1]['ms']:.4f} ms  "
              f"plain {rows[-1]['plain_ms']:.4f} ms  sdpa "
              f"{rows[-1]['library_ms']:.4f} ms  {bound_text(rows[-1])}")
    d = 512
    for sq, sk in ((4100, 4100), (300, 70)):
        q = torch.randn((1, 1, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((1, 1, sk, d), generator=gen, device="cuda") for _ in range(2))
        out = K.flash_attention(q, k, v, d ** -0.5)
        got = K.flash_attention_residuals(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        want = K.flash_attention_residuals_plain(q, k, v, d ** -0.5)
        err = max_err(torch, out, want[0])
        if err > TC_TOL:
            raise RuntimeError(f"K1 d=512 Sq={sq} Sk={sk}: max|Δ| {err} > {TC_TOL}")
        for name, a, w in zip(("out", "l", "m"), got, want):
            rel_err(torch, a, w, f"K3 d=512 Sq={sq} Sk={sk} {name}", TC_TOL)
        print(f"K1 d=512 Sq={sq} Sk={sk}: max|Δ| {err:.3g}; with residuals "
              "within tolerance")
    return rows


def k2_phases(torch, K):
    """K2 at every main-path (P, D, Kp): the 16 cross sites (Replace and
    Refine operands) and the 6 self sites inside (α = 1) and outside (α = 0)
    the injection window; and the replay edit's cross sites at P = 4096
    (Replace with Reweight's equalizer)."""
    from p2p_tpu_torch.controllers.factory import (
        attention_refine,
        attention_replace,
        make_controller,
    )
    from p2p_tpu_torch.controllers.kernel_spec import edit_operands, kernel_edit_spec
    from p2p_tpu_torch.models.config import SD14, unet_layout
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    tok = HashWordTokenizer()
    refine_prompts = ["a cat riding a bicycle", "a cat riding a red bicycle"]
    ctrls = {"replace": attention_replace(PROMPTS, STEPS, 0.8, 0.4, tok, store=False),
             "refine": attention_refine(refine_prompts, STEPS, 0.8, 0.4, tok, store=False),
             "reweight": make_controller(PROMPTS, True, 0.8, 0.4, tok, STEPS,
                                         equalizer_params=EQUALIZER)}
    metas = {}
    for m in unet_layout(SD14.unet).metas:
        metas.setdefault((m.is_cross, m.pixels), m)
    gen = torch.Generator("cuda").manual_seed(2)
    cases = [(kind, metas[(True, p)], 0) for p in (4096, 1024, 256, 64)
             for kind in ("replace", "refine")]
    cases += [("replace", metas[(False, p)], step) for p in (256, 64) for step in (0, 45)]
    cases += [("reweight", metas[(True, 4096)], 0)]
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
        iters = 20 if meta.pixels >= 1024 else 50
        rows.append({
            "site": label, "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.edit_attention(q, k, v, scale, spec, ops), iters),
            "plain_ms": cuda_ms(torch, lambda: K.edit_attention_plain(
                q, k, v, scale, spec, ops), 5),
            "library_ms": None, **bound(flops, nbytes, False)})
        print(f"K2 {label}: max|Δ| {err:.3g}  kernel {rows[-1]['ms']:.4f} ms  "
              f"plain {rows[-1]['plain_ms']:.4f} ms  {bound_text(rows[-1])}")
    return rows


def rel_err(torch, got, want, what: str, tol: float = KERNEL_TOL) -> float:
    """max|Δ| of a kernel output against its plain version, raising past
    ``tol`` relative to the plain version's largest magnitude."""
    err = max_err(torch, got, want)
    top = want.abs().max().item()
    print(f"  {what}: max|Δ| {err:.3g}, {err / top:.3g} of the largest magnitude")
    if err > tol * top:
        raise RuntimeError(f"{what}: max|Δ| {err} > {tol} x {top}")
    return err


def k34_phases(torch, K, F):
    """K3 (forward with residuals) and K4 (backward: dk/dv and dq passes) at
    the U-Net 64² self sites under the inversion's gradient, (1, 8, 4096,
    40); each pass against its plain version on the same inputs, and
    ``scaled_dot_product_attention`` forward and backward as yardsticks."""
    shape = (1, 8, 4096, 40)
    b, h, s, d = shape
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    scale = d ** -0.5
    out, l, m = K.flash_attention_residuals(q, k, v, scale)
    torch.cuda.synchronize()
    p_out, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, scale)
    err3 = max(rel_err(torch, out, p_out, "K3 out"), rel_err(torch, l, p_l, "K3 l"),
               rel_err(torch, m, p_m, "K3 m"))
    # Both K4 passes and their plain versions take the plain forward's
    # residuals, so each is held against its plain version alone.
    di = (p_out * do).sum(dim=-1)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, do, p_l, p_m, di, scale)
    dq = K.flash_attention_bwd_dq(q, k, v, do, p_l, p_m, di, scale)
    torch.cuda.synchronize()
    p_dk, p_dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, p_l, p_m, di, scale)
    p_dq = K.flash_attention_bwd_dq_plain(q, k, v, do, p_l, p_m, di, scale)
    err_dkv = max(rel_err(torch, dk, p_dk, "K4 dk", TC_TOL),
                  rel_err(torch, dv, p_dv, "K4 dv", TC_TOL))
    err_dq = rel_err(torch, dq, p_dq, "K4 dq", TC_TOL)
    # Deterministic: a second launch of each pass gives the same bits.
    dk2, dv2 = K.flash_attention_bwd_dkv(q, k, v, do, p_l, p_m, di, scale)
    dq2 = K.flash_attention_bwd_dq(q, k, v, do, p_l, p_m, di, scale)
    for name, a, b2 in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        if not torch.equal(a, b2):
            raise RuntimeError(f"K4 {name}: two launches differ")
    print("K4: two launches give bitwise-equal dq, dk and dv")

    # Ragged edges: a last tile part-full (S = 4100), and Sq != Sk.
    for sq, sk in ((4100, 4100), (300, 70)):
        rq, rdo = (torch.randn((1, 2, sq, d), generator=gen, device="cuda")
                   for _ in range(2))
        rk, rv = (torch.randn((1, 2, sk, d), generator=gen, device="cuda")
                  for _ in range(2))
        got = K.flash_attention_residuals(rq, rk, rv, scale)
        want = K.flash_attention_residuals_plain(rq, rk, rv, scale)
        got += K.flash_attention_bwd(rq, rk, rv, want[0], rdo, want[1], want[2], scale)
        want += K.flash_attention_bwd_plain(rq, rk, rv, want[0], rdo, want[1],
                                            want[2], scale)
        torch.cuda.synchronize()
        for name, a, w in zip(("out", "l", "m", "dq", "dk", "dv"), got, want):
            rel_err(torch, a, w, f"K3/K4 Sq={sq} Sk={sk} {name}",
                    TC_TOL if name.startswith("d") else KERNEL_TOL)
    print("K3/K4 ragged edges (Sq, Sk) = (4100, 4100), (300, 70): within tolerance")

    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True), 10)
    n = b * h * s * d * 4                    # bytes of one (B, H, S, D) f32 tensor
    stats = 4 * b * h * s                    # bytes of one (B, H, S) f32 tensor
    flops = 2.0 * b * h * s * s * d          # one S x S x d product
    rows = {}
    rows["K3"] = {"shape": list(shape), "max_abs_err": err3,
                  "ms": cuda_ms(torch, lambda: K.flash_attention_residuals(q, k, v, scale), 20),
                  "plain_ms": cuda_ms(torch, lambda: K.flash_attention_residuals_plain(
                      q, k, v, scale), 3),
                  "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                      q, k, v, scale=scale), 20),
                  **bound(2 * flops, 4 * n + 2 * stats, False)}
    rows["K4_dkv"] = {"shape": list(shape), "max_abs_err": err_dkv,
                      "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv(
                          q, k, v, do, p_l, p_m, di, scale), 10),
                      "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv_plain(
                          q, k, v, do, p_l, p_m, di, scale), 3),
                      "library_ms": sdpa_bwd_ms,
                      **bound(4 * flops, 6 * n + 3 * stats, True)}
    rows["K4_dq"] = {"shape": list(shape), "max_abs_err": err_dq,
                     "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq(
                         q, k, v, do, p_l, p_m, di, scale), 10),
                     "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq_plain(
                         q, k, v, do, p_l, p_m, di, scale), 3),
                     "library_ms": sdpa_bwd_ms,
                     **bound(3 * flops, 5 * n + 3 * stats, True)}
    for name, r in rows.items():
        print(f"{name} {shape}: max|Δ| {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} ms  "
              f"{bound_text(r)}")
    return rows


def main_path(torch, K, pipe):
    from p2p_tpu_torch import KernelConfig, attention_replace, text2image
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models.config import SD14, unet_layout

    ctrl = attention_replace(PROMPTS, STEPS, 0.8, 0.4, pipe.tokenizer, store=False)
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
    counts = path_counts(K)
    want = {**dict.fromkeys(counts, 0), "flash_attn": STEPS * 5 + 1,
            "fused_edit": STEPS * 22, "flash_merge": vae_merges(torch, pipe, 2)}
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


def inversion_path(torch, K, pipe):
    """``invert`` at SD-1.4 full width and the reference defaults, on a
    seeded 512² uint8 image. The launch counts follow from the layout and
    the inner iterations n the early stop left: every forward without
    gradient runs K1 at the 5 self sites of 4096 pixels; in an inner
    iteration's forward the site before the first cross site does not see
    the embedding and runs K1 too, while the 4 after it run K3, and the
    backward runs K4's two passes at each of those 4."""
    import numpy as np

    from p2p_tpu_torch.engine import inversion as inv
    from p2p_tpu_torch.models.config import unet_layout

    metas = unet_layout(pipe.config.unet).metas
    first_cross = min(m.layer_idx for m in metas if m.is_cross)
    big = [m for m in metas if not m.is_cross and m.pixels >= 2048]
    n_const = sum(1 for m in big if m.layer_idx < first_cross)
    n_grad = len(big) - n_const
    cfg = pipe.config
    size = cfg.image_size
    image = np.random.default_rng(IMAGE_SEED).integers(0, 256, (size, size, 3),
                                                       dtype=np.uint8)
    # Time the two phases of invert() by wrapping the module functions it
    # calls.
    seconds = {}

    def timed(name):
        fn = getattr(inv, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return out
        setattr(inv, name, wrapper)
        return fn

    originals = {name: timed(name) for name in ("ddim_invert", "null_optimize")}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        art = inv.invert(pipe, image, PROMPTS[0], num_steps=STEPS,
                         num_inner_steps=INNER_STEPS, early_stop_epsilon=EARLY_STOP,
                         device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(inv, name, fn)
    counts = path_counts(K)
    peak = torch.cuda.max_memory_allocated()
    n = sum(art.inner_steps)
    want = {**dict.fromkeys(counts, 0),
            # inversion, cond + advance forwards, inner forwards, VAE encode
            # and the reconstruction's decode
            "flash_attn": STEPS * len(big) + STEPS * 2 * len(big) + n * n_const + 2,
            "flash_attn_residuals": n * n_grad,
            "flash_attn_bwd_dq": n * n_grad,
            "flash_attn_bwd_dkv": n * n_grad,
            "flash_merge": 2 * vae_merges(torch, pipe, 1)}
    if counts != want:
        raise RuntimeError(f"inversion launch counts {counts}, expected {want}")
    if art.uncond_embeddings.shape != (STEPS, 1, cfg.text.max_length,
                                       cfg.text.hidden_dim):
        raise RuntimeError(f"embeddings {art.uncond_embeddings.shape}")
    if not (np.isfinite(art.uncond_embeddings).all() and np.isfinite(art.x_t).all()):
        raise RuntimeError("non-finite inversion output")
    stats = {"s_total": total, "s_ddim_invert": seconds["ddim_invert"],
             "s_null_optimize": seconds["null_optimize"], "inner_iterations": n,
             "ms_per_inner_iteration": seconds["null_optimize"] / n * 1e3,
             "inner_steps": art.inner_steps, "max_memory_allocated": peak,
             "launches": counts}
    print(f"inversion: {total:.3f} s ({seconds['ddim_invert']:.3f} s DDIM "
          f"inversion, {seconds['null_optimize']:.3f} s optimization); {n} inner "
          f"iterations, {stats['ms_per_inner_iteration']:.2f} ms each (cond and "
          f"advance forwards included); peak memory {peak / 2**30:.2f} GiB")
    print(f"inversion: launches {counts}; inner steps {art.inner_steps}")
    return art, image, stats


def replay_path(torch, K, pipe, art, image):
    """The replay edit of the inversion: Replace + LocalBlend + Reweight with
    the optimized embeddings, with and without the kernels, and the source
    row's reconstruction against the raw ``""`` uncond."""
    from p2p_tpu_torch import KernelConfig, make_controller, text2image
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models import vae as vae_mod
    from p2p_tpu_torch.models.config import unet_layout

    prompts = [art.prompt, PROMPTS[1]]
    ctrl = make_controller(prompts, True, 0.8, 0.4, pipe.tokenizer, STEPS,
                           blend_words=BLEND_WORDS, equalizer_params=EQUALIZER)
    metas = unet_layout(pipe.config.unet).metas
    variants = [site_variant(KernelConfig(), ctrl, m) for m in metas]
    n_k2 = variants.count("fused-edit")
    n_k1 = sum(1 for v, m in zip(variants, metas) if v == "flash" and m.pixels >= 2048)
    x_t = torch.from_numpy(art.x_t).cuda()
    ups = torch.from_numpy(art.uncond_embeddings).cuda()

    def run(kernels, uncond):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, prompts, ctrl, num_steps=STEPS, latent=x_t,
                                    uncond_embeddings=uncond, kernels=kernels,
                                    device="cuda", return_latents=True)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    K.reset_launch_counts()
    img, lat, secs = run(KernelConfig(), ups)
    counts = path_counts(K)
    want = {**dict.fromkeys(counts, 0), "flash_attn": STEPS * n_k1 + 1,
            "fused_edit": STEPS * n_k2, "flash_merge": vae_merges(torch, pipe, 2)}
    if counts != want:
        raise RuntimeError(f"replay launch counts {counts}, expected {want}")
    size = pipe.config.image_size
    if img.shape != (2, size, size, 3) or not bool(torch.isfinite(lat).all()):
        raise RuntimeError(f"replay images {tuple(img.shape)} or non-finite latents")
    _, lat_ref, secs_ref = run(None, ups)
    drift = max_err(torch, lat, lat_ref)
    if drift > DRIFT_TOL:
        raise RuntimeError(f"replay latents drift {drift} > {DRIFT_TOL}")
    _, lat_raw, _ = run(KernelConfig(), None)
    with torch.no_grad():
        target = vae_mod.encode(pipe.vae, pipe.config.vae, torch.from_numpy(
            image.astype("float32") / 127.5 - 1.0)[None].cuda())
    err_opt = torch.mean((lat[0] - target[0]) ** 2).item()
    err_raw = torch.mean((lat_raw[0] - target[0]) ** 2).item()
    if not err_opt < err_raw:
        raise RuntimeError(f"null-text invariant: source-row MSE to the encoded "
                           f"image {err_opt} with the optimized embeddings, "
                           f"{err_raw} with the raw uncond")
    print(f"replay: launches {counts} ({n_k1} K1 and {n_k2} K2 sites); latents "
          f"max|Δ| vs kernels=None {drift:.3g}; {secs:.3f} s with kernels, "
          f"{secs_ref:.3f} s without")
    print(f"replay: source-row MSE to the encoded image {err_opt:.6g} optimized "
          f"vs {err_raw:.6g} raw uncond")
    return counts, {"s_per_pair": secs, "s_per_pair_materialized": secs_ref,
                    "latent_drift": drift, "mse_optimized": err_opt,
                    "mse_raw": err_raw}


def kernel_entry(name, source, replaces, launches, rows, **extra):
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_on": head["bound_on"], "bound_f32_ms": head["bound_f32_ms"],
            "bound_3xtf32_ms": head["bound_3xtf32_ms"],
            "library_ms": head["library_ms"], **extra, "geometries": rows}


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
            if "Function properties for" in line:
                line = line.split("Function properties for")[1]
            elif "registers" not in line and "spill" not in line:
                continue
            print(f"  {name}: {line.strip()}")

    from p2p_tpu_torch import random_pipeline
    from p2p_tpu_torch.models.config import SD14
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    k1 = k1_phases(torch, K, F)
    k2 = k2_phases(torch, K)
    k34 = k34_phases(torch, K, F)
    t0 = time.perf_counter()
    pipe = random_pipeline(SD14, HashWordTokenizer(), "cuda", seed=0)
    torch.cuda.synchronize()
    print(f"SD-1.4 random weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    counts, path = main_path(torch, K, pipe)
    art, image, inversion = inversion_path(torch, K, pipe)
    replay_counts, replay = replay_path(torch, K, pipe, art, image)
    inv_counts = inversion["launches"]
    result = {"kernels": [
        kernel_entry("flash_attn", "p2p_tpu_torch/csrc/flash_attn.cu",
                     "p2p_tpu/models/nn.py:330", counts["flash_attn"], k1,
                     merge_launches={"main_path": counts["flash_merge"],
                                     "inversion": inv_counts["flash_merge"],
                                     "replay": replay_counts["flash_merge"]},
                     note="launches counts wrapper calls; a d = 512 call that "
                          "splits its keys also launches flash_merge_kernel "
                          "(merge_launches), and its ms includes the merge"),
        kernel_entry("fused_edit", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", counts["fused_edit"], k2),
        kernel_entry("flash_attn_residuals", "p2p_tpu_torch/csrc/flash_attn.cu",
                     "p2p_tpu/models/nn.py:343", inv_counts["flash_attn_residuals"],
                     [k34["K3"]]),
        kernel_entry("flash_attn_bwd_dq", "p2p_tpu_torch/csrc/flash_attn_bwd.cu",
                     "p2p_tpu/models/nn.py:308", inv_counts["flash_attn_bwd_dq"],
                     [k34["K4_dq"]]),
        kernel_entry("flash_attn_bwd_dkv", "p2p_tpu_torch/csrc/flash_attn_bwd.cu",
                     "p2p_tpu/models/nn.py:308", inv_counts["flash_attn_bwd_dkv"],
                     [k34["K4_dkv"]]),
    ], "main_path": path, "inversion": inversion, "replay": replay,
        "replay_launches": replay_counts, "card": card}
    # K3 + K4 per inner iteration from the kernel phase's times, against the
    # measured inner iteration.
    n_grad = inv_counts["flash_attn_residuals"] // inversion["inner_iterations"]
    k34_ms = n_grad * sum(k34[k]["ms"] for k in ("K3", "K4_dq", "K4_dkv"))
    inversion["k3_k4_ms_per_inner_iteration"] = k34_ms
    print(f"inversion: K3 + K4 at {n_grad} sites take {k34_ms:.3f} ms of the "
          f"{inversion['ms_per_inner_iteration']:.2f} ms inner iteration "
          f"({100 * k34_ms / inversion['ms_per_inner_iteration']:.1f} %)")
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
