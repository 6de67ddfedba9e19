#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the CUDA kernels, holds each
against its plain PyTorch version at every geometry its paths give it, and
drives the SD-1.4 Replace edit (under DDIM, PLMS and DPM-Solver++), a
null-text inversion and its replay edit, the SD-2.1 768-v Replace edit,
null-text inversion and replay, and the LDM-256 Replace edit, end to end
through the package's entry points.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository
checkout around this file; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   ``p2p_tpu_torch/csrc/*.cu`` for ``sm_90a`` (one ``nvcc`` per source, in
   parallel);
2. kernel phases: K1 (flash attention), K2 (fused edit: an f32 fold, then
   the main kernel), K3 (flash forward with residuals) and K4 (flash
   backward, a dk/dv and a dq pass) against their plain versions on the same
   card inputs (f32, TF32 off for PyTorch), all on the tensor cores in
   3xTF32 and held to max|Δ| ≤ 1e-5 (K2, K3 and K4 relative to the plain
   output's largest magnitude), K1 at both head dims also at ragged lengths;
   K1 at every path shape, K2 at its 13 geometries, K3 and both K4 passes
   give bitwise-equal outputs from two launches; each timed with CUDA events
   beside its plain version, its roofline bound on the units it runs on
   (``bound_ms``; both the f32 CUDA-core and the 3xTF32 tensor-core figures
   beside it) and, where one exists, a PyTorch call computing the same
   function (``scaled_dot_product_attention`` forward, or its backward; for
   K2, which has none, SDPA at its shapes as a yardstick); K2 also as a
   replayed CUDA graph (its device time without the host's); the d = 40
   kernel's occupancy (blocks per SM); K1 at d = 512 with the key split
   ``kernels.flash.d512_splits`` gives each call (and its merge);
3. the main path: random SD-1.4 weights at full width from seed 0, 512²,
   2 prompts, DDIM 50 steps, CFG 7.5, an ``attention_replace`` edit
   (store off) with ``kernels=KernelConfig()``; the launch counts must be
   exactly 5 K1 and 22 K2 (each with its fold) per step plus 1 K1 for the
   VAE, and the final latents must agree with the ``kernels=None`` run
   within 1e-2;
4. the inversion path: ``invert`` of a seeded 512² image at the reference
   defaults but the depth (10 inner steps, early stop 1e-5, CFG 7.5; 20
   outer steps, cut from 50, ``SD14_INVERSION_STEPS``, to keep the script
   near half its time limit beside phase 8's 768-v inversions); the
   launch counts must be exactly what the layout and the inner-iteration
   counts give (see ``inversion_path``), K1's key-split merge once per
   d = 512 call that splits its keys on this card, and every embedding
   finite;
5. the replay edit of that artifact (Replace + LocalBlend + Reweight) with
   ``kernels=KernelConfig()`` (exact K1/K2 counts), with ``kernels=None``
   (latents within 1e-2) and with the raw ``""`` uncond: the source row must
   end closer to the encoded image's latent with the optimized embeddings;
6. bf16: K1 at d = 40 (``flash_fwd_sm90_kernel<40>``: wgmma and TMA, the
   40-column rows landed in d = 64's swizzled layout; SASS and ptxas
   checked as phase 8's) and K2 in bf16 against their bf16 plain versions
   (within 1e-2 of the plain output's largest magnitude, bitwise across
   two launches; K1 at (4, 8, 4096, 40), (1, 8, 4096, 40) and ragged, K2
   at its 13 geometries), timed beside SDPA in bf16 and their bound at the
   bf16 tensor-core rate (K1 also beside its exponentials' floor,
   ``ex2_floor_ms``, printed only, as K3's is); then the Replace edit and
   the replay of the f32 artifact with ``dtype=torch.bfloat16``: exactly 5
   bf16 K1 and 22 (5 in the replay) bf16 K2, each with its bf16 fold, a
   step, and 1 f32 K1 for the f32 VAE decode; the fused-vs-materialized
   bf16 drift (RMS) below √2 times the bf16-vs-f32 distance (RMS) of the
   same seed, and the null-text invariant;
7. the bf16 inversion: the bf16 sums of the norms' backward
   (``window_sum_bf16_kernel``, XLA's windowed bf16 reduction) at the
   inversion's group- and layer-norm shapes, bitwise equal to their plain
   version and across two launches, timed beside ``torch.sum``; K3 and both
   K4 passes in bf16 at (1, 8, 4096, 40) and
   ragged (S = 4100; Sq = 300 with Sk = 70), K3's ``m`` and ``l`` within
   ``TC_TOL`` relative, and K1 in bf16 at d = 512
   (``flash_d512_sm90_kernel``: wgmma and TMA, its SASS and ptxas checked
   as phase 8's; with its key split and merge), (1, 1, 4096, 512), (1, 1,
   9216, 512) and ragged, each within ``BF16_TOL`` of its bf16 plain
   version's largest magnitude and bitwise across two launches, timed
   beside SDPA in bf16 (forward, or for K4 the backward alone, with forward
   and backward together beside it) and the bf16 bound; the key-split sweep
   of both d = 512 kernels at the 768² VAE's shapes (``d512_split_sweep``:
   each split of ``D512_SWEEP_SPLITS`` timed beside the rule's pick); then
   ``invert(dtype=torch.bfloat16)`` at phase 4's settings on the same
   image, with exact launch counts (bf16 K1 at d = 40 for every forward
   without gradient and the encode's bf16 K1 at d = 512, one f32 K1 for the
   reconstruction's decode, bf16 K3 and K4 at the gradient's sites, a merge
   for each d = 512 call that splits its keys, and the norms' backward sums
   of every gradient, as many as one gradient launches on its own), finite
   outputs, its time
   beside the f32 inversion's and the bf16-vs-f32 RMS distances of x_T and
   of the embeddings; and the bf16 replay of its artifact (exact launch
   counts, the null-text invariant);
8. SD-2.1 (``models/config.py:SD21`` and ``SD21_BASE``, head dim 64): K1
   at d = 64 in f32 (``flash_fwd_tf32_sm90_kernel``: 3xTF32 on tf32 wgmma
   and TMA, its SASS and ptxas checked as bf16's; within ``TC_TOL``) and
   bf16 (``flash_fwd_sm90_kernel<64>``: wgmma and TMA, its SASS checked for
   HGMMA and UTMALDG and no HMMA; within ``BF16_TOL``) at the self sites
   of both configs, (4, 5, 9216, 64), (4, 10, 2304, 64) and (4, 5, 4096,
   64), and ragged; K3 (f32 ``m``, ``l`` within ``TC_TOL`` relative) and
   both K4 passes at d = 64 in f32 (3xTF32, within ``TC_TOL``) and bf16
   (within ``BF16_TOL``) at the inversion's gradient sites of both
   configs, (1, 5, 9216, 64), (1, 10, 2304, 64) and (1, 5, 4096, 64), and
   ragged (Sq = 300 with Sk = 70, and Sq = 70 with Sk = 300); K4 is
   ``flash_bwd_{dkv,dq}_sm90_kernel`` in bf16 and
   ``flash_bwd_{dkv,dq}_tf32_sm90_kernel`` in f32 (3xTF32), both on wgmma
   and TMA (SASS checked as K1's; ptxas must report no spills in any sm90
   library), and K4 and SDPA's
   backward are also timed as replayed CUDA graphs; K2 at every D = 64
   geometry of both configs' Replace edits in
   both dtypes; K1 at d = 512 at the 768² VAE's (2, 1, 9216, 512) and (1,
   1, 9216, 512) (in phases 2 and 7) and the norms' window sums at 768-v's
   shapes (phase 7); each bitwise across two launches and timed beside its
   plain version, its bound and SDPA. Then the 768-v edit (2 prompts, DDIM
   50 steps, CFG 7.5, ``attention_replace(..., 0.8, 0.4)``) in f32 and in
   bf16 with exact launch counts by head dim
   (``kernels.head_dim_launch_counts``), the f32 drift within
   ``DRIFT_TOL`` and the bf16 drift held as in phase 6; then the 768-v
   null-text inversion of a seeded 768² image at the reference defaults
   (50 outer steps, 10 inner, early stop 1e-5) in f32 and in bf16, with
   exact launch counts by kernel and head dim (9 K3 and 9 of each K4 pass
   at d = 64 an inner iteration, 4 at 96² and 5 at 48²), finite outputs,
   the bf16 run's time beside the f32 one's and their RMS distances, and
   the replay of each artifact (LocalBlend at 24): the f32 one in f32
   (drift within ``DRIFT_TOL``), the bf16 one in bf16 (drift held against
   its own f32 materialized replay as in phase 6), each with the null-text
   invariant; the 512-base config runs only its kernel geometries;
9. the main path's edit under the PLMS and DPM-Solver++ samplers (right
   after phase 3, on its pipeline), in f32: PLMS makes 51 U-Net calls of 50
   steps (its second timestep repeated), DPM 50, so exactly 5 K1 and 22 K2
   (each with its fold) a call plus 1 K1 for the VAE, and the final latents
   within ``DRIFT_TOL`` of the ``kernels=None`` run's (``multistep_path``);
10. LDM-256 (``models/config.py:LDM256``: LDMBert, 32² latent, head dim
   64, the VQ-f8 decode): K2 at every geometry of its Replace edit (4
   cross sites, 3 self sites at steps 0 and 45) in both dtypes with phase
   8's D = 64 geometries, then the edit (2 prompts, DDIM 50 steps, CFG 5.0)
   from random weights of seed 0 in f32 and in bf16, the decode in f32:
   exactly 27 K2 (each with its fold) a step and no K1, K3 or K4 (its
   largest self site, 1024 positions, is under the flash threshold), the
   f32 drift within ``DRIFT_TOL`` and the bf16 drift held as in phase 6
   (``ldm_path``, after the SD-2.1 pipeline is freed);
11. the script's wall time, one ``{"kernels": [...]}`` line, then the device
   line last.

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

# Kernel vs plain version, f32, same inputs, for every kernel (all on the
# tensor cores in 3xTF32): they keep f32 accuracy, and this limit fails one
# TF32 pass (tests/test_torch_tf32.py, tests/test_torch_flash_tc.py,
# tests/test_torch_fused_edit_tc.py) or one f32 accumulator over a 4096-long
# sum.
TC_TOL = 1e-5
# The bf16 kernels (K1 at d = 40, K2) against their bf16 plain versions,
# relative to the plain output's largest magnitude: both round P and the
# output to bf16 (the fold also its values), so they differ by a few bf16
# ulps (2^-8 relative each) where a rounding falls the other way.
BF16_TOL = 1e-2
DRIFT_TOL = 1e-2       # fused-edit run vs materialized run, final latents
# bf16 runs: two bf16 runs that round anywhere differently (the fused-edit
# run and the materialized one) part within the first step, each by bf16's
# own distance from f32, and stay about that far apart: over SD-1.4's 50
# steps their RMS distance tracks the bf16-vs-f32 RMS distance at every step
# (PERF.md, bf16 findings). Two independent errors of one size are √2 of it
# apart, so the fused-vs-materialized RMS drift is held below √2 times the
# bf16-vs-f32 RMS distance of the materialized run; a kernel that computed
# something else would part from the first step by far more.
BF16_DRIFT_FACTOR = math.sqrt(2.0)
STEPS = 50
PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]
INNER_STEPS = 10       # null-text inner iterations per outer step
# Outer steps of the SD-1.4 inversions (and so of their replays): cut from
# the reference's 50 to keep the script near half its time limit beside the
# SD-2.1 768-v inversions, which run all 50.
SD14_INVERSION_STEPS = 20
EARLY_STOP = 1e-5      # null-text early-stop threshold
IMAGE_SEED = 0         # the inverted image, uint8 noise from numpy
BLEND_WORDS = (("cat",), ("dog",))
EQUALIZER = {"words": ("dog",), "values": (2.0,)}

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, TF32 and bf16
# on the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# The exponentials' floor of a softmax on the card: 16 ex2 a clock an SM
# (the MUFU) at the H100 SXM's 1.98 GHz boost clock.
EX2_PER_CLOCK_SM = 16
SM_CLOCK_HZ = 1.98e9


def bound(flops: float, nbytes: float, tensor_cores: bool, bf16: bool = False) -> dict:
    """The least time for ``flops`` operations and ``nbytes`` of memory
    traffic on the units the kernel runs them on (``bound_ms``, with what
    bounds it): bf16 operands on the tensor cores, one product each, when
    ``bf16``; else f32 operands on the tensor cores in 3xTF32, three TF32
    products per product, when ``tensor_cores``, else the CUDA cores in
    f32. The f32 figures stand beside it (``bound_3xtf32_ms``,
    ``bound_f32_ms``)."""
    t_bytes = nbytes / PEAK_BYTES
    t_f32, t_tc = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS
    t_ops = flops / PEAK_BF16_FLOPS if bf16 else (t_tc if tensor_cores else t_f32)
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_on": ("tensor cores, bf16" if bf16 else "tensor cores, 3xTF32"
                         if tensor_cores else "CUDA cores, f32"),
            "bound_f32_ms": max(t_f32, t_bytes) * 1e3,
            "bound_3xtf32_ms": max(t_tc, t_bytes) * 1e3}


def ex2_floor_ms(torch, exps: float) -> float:
    """The least ms the card's SMs take for ``exps`` exponentials (one
    ``ex2`` a score in the flash kernels) at the boost clock: a floor beside
    ``bound_ms`` that the tensor cores' does not cover. It assumes a clock
    the card may not hold under load, so it is printed beside the times and
    kept out of the ``kernels`` line."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (EX2_PER_CLOCK_SM * sms * SM_CLOCK_HZ) * 1e3


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


def rms_err(torch, a, b) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def bf16_drift(torch, what: str, lat16, lat16_ref, lat32_ref) -> dict:
    """The bf16 fused-edit latents ``lat16`` against the bf16 materialized
    ones and the bf16 materialized against the f32 materialized ones: max
    and RMS of each; raises unless the RMS drift is below
    ``BF16_DRIFT_FACTOR`` times the RMS bf16-vs-f32 distance."""
    r = {"latent_drift": max_err(torch, lat16, lat16_ref),
         "latent_drift_rms": rms_err(torch, lat16, lat16_ref),
         "bf16_vs_f32_latent_distance": max_err(torch, lat16_ref, lat32_ref),
         "bf16_vs_f32_latent_distance_rms": rms_err(torch, lat16_ref, lat32_ref)}
    print(f"{what}: fused vs materialized bf16 latents max|Δ| {r['latent_drift']:.4g} "
          f"rms {r['latent_drift_rms']:.4g}; materialized bf16 vs f32 max|Δ| "
          f"{r['bf16_vs_f32_latent_distance']:.4g} rms "
          f"{r['bf16_vs_f32_latent_distance_rms']:.4g}")
    if not r["latent_drift_rms"] < BF16_DRIFT_FACTOR * r["bf16_vs_f32_latent_distance_rms"]:
        raise RuntimeError(f"{what}: bf16 fused-edit RMS drift {r['latent_drift_rms']} is "
                           f"not below {BF16_DRIFT_FACTOR:.4f} x the bf16-vs-f32 RMS "
                           f"distance {r['bf16_vs_f32_latent_distance_rms']}")
    return r


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def path_counts(K) -> dict:
    """Every wrapper's launch count, K1's key-split merges, the f32 d = 64
    forward's split passes and K2's folds, f32 and bf16."""
    return {**K.launch_counts(), "flash_merge": K.merge_launches(),
            "flash_split": K.split_launches(), "fused_edit_fold": K.fold_launches(),
            **K.bf16_launch_counts()}


def split_passes(dims: dict) -> int:
    """The split passes a run launches, given its K1/K3 launches by head dim
    (``kernels.head_dim_launch_counts``): one before each K1 or K3 call in
    f32 at d = 64."""
    return dims.get("K1 f32 d=64", 0) + dims.get("K3 f32 d=64", 0)


def vae_head_dim(cfg) -> int:
    """The head dim of the VAE's mid attention, one head over its widest
    channels: 512 at SD's VAE."""
    return cfg.vae.base_channels * cfg.vae.channel_mults[-1]


def vae_merges(torch, pipe, batch: int, dtype=None) -> int:
    """Merge launches of one K1 call at the VAE's mid attention, d = 512,
    in ``dtype`` (f32 by default): 1 when the card's SM count makes the call
    split its keys (``kernels.flash.d512_splits``), else 0."""
    s = pipe.config.latent_size ** 2
    return int(d512_split_count(torch, dtype or torch.float32, batch, s, s) > 1)


def d512_split_count(torch, dtype, bh: int, sq: int, sk: int) -> int:
    """The key splits a d = 512 K1 call of ``bh`` batch·heads takes on this
    card."""
    from p2p_tpu_torch.kernels.flash import d512_splits

    return d512_splits(dtype, bh, sq, sk, torch.cuda.get_device_properties(0)
                       .multi_processor_count)


#: Key splits timed at the VAE's 768² shapes for each dtype's d = 512 kernel.
D512_SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 9, 12, 16)


def d512_split_sweep(torch, F):
    """Both d = 512 kernels (f32 ``flash_d512_kernel``, bf16
    ``flash_d512_sm90_kernel``) at the 768² VAE's (1, 1, 9216, 512) and (2, 1,
    9216, 512), through their C entries with each key split of
    ``D512_SWEEP_SPLITS`` (the merge included), beside the split
    ``kernels.flash.d512_splits`` picks, the rule's cost of each (rounds ×
    the longest split's key tiles, plus the merge's weight) and SDPA in the
    same dtype: the timings the rule is set from. Every split's output is
    held against the unsplit one (``TC_TOL`` in f32, ``BF16_TOL`` of the
    largest magnitude in bf16)."""
    from p2p_tpu_torch.kernels import build, flash

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        entry = flash.entry_for(dtype, 512)
        lib, fn = flash.forward_entry(entry)
        tile = flash.D512_KEY_TILE[dtype]
        for b in (1, 2):
            shape = (b, 1, 9216, 512)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            s, scale = shape[2], 512 ** -0.5
            blocks, key_tiles = b * -(-s // flash.D512_TILE), -(-s // tile)
            pick = flash.d512_splits(dtype, b, s, s, sms)
            times, costs, ref = {}, {}, None
            for n in sorted(set(D512_SWEEP_SPLITS) | {pick}):
                out = torch.empty_like(q)
                part = (torch.empty(n * b * s * (512 + 2), device="cuda")
                        if n > 1 else None)

                def call():
                    build.check(lib, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), None, None,
                                        None if part is None else part.data_ptr(), n, b,
                                        s, s, 512, scale, stream), entry)

                call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = out.clone()
                elif dtype == torch.float32:
                    if max_err(torch, out, ref) > TC_TOL:
                        raise RuntimeError(f"d = 512 f32 {shape}, {n} splits: differs "
                                           "from the unsplit output")
                else:
                    rel_err(torch, out, ref, f"d = 512 bf16 {shape}, {n} splits", BF16_TOL)
                times[n] = cuda_ms(torch, call, 5 if dtype == torch.float32 else 10)
                costs[n] = (math.ceil(blocks * n / sms) * math.ceil(key_tiles / n)
                            + (flash.D512_MERGE[dtype] * n * blocks / sms if n > 1 else 0.0))
            best = min(times, key=times.get)
            sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                           5 if dtype == torch.float32 else 10)
            rows.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape),
                         "blocks": blocks, "key_tiles": key_tiles, "pick": pick,
                         "fastest": best, "ms": times, "rule_cost": costs,
                         "sdpa_ms": sdpa})
            print(f"d = 512 splits {rows[-1]['dtype']} {shape} ({blocks} blocks, {key_tiles} "
                  f"key tiles of {tile}): rule picks {pick} (cost {costs[pick]:.1f}), fastest "
                  f"{best}; ms " + ", ".join(f"{n}: {t:.4f}" for n, t in times.items()) +
                  f"; sdpa {sdpa:.4f}")
    return rows


def k1_phases(torch, K, F):
    """K1 at the U-Net 64² self sites and the VAE mid attention: batch 4 and
    2 on the edit paths, batch 1 in the inversion (its forwards without
    gradient, and the VAE encode), and SD-2.1's VAE at 96² latent pixels,
    (2, 1, 9216, 512) in the edit and (1, 1, 9216, 512) in the inversion
    (288 and 144 one-SM blocks, whose short last round the key split
    fills), each twice for bitwise-equal outputs, the d = 512 calls with the
    key splits ``kernels.flash.d512_splits`` gives them (merge included);
    then both kernels at ragged lengths (S = 4100, and Sq = 300 with
    Sk = 70), the d = 512 one also with K3's residuals."""
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for shape, iters in (((4, 8, 4096, 40), 20), ((2, 1, 4096, 512), 10),
                         ((1, 8, 4096, 40), 20), ((1, 1, 4096, 512), 10),
                         ((2, 1, 9216, 512), 5), ((1, 1, 9216, 512), 5)):
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        scale = d ** -0.5
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = max_err(torch, out, K.flash_attention_plain(q, k, v, scale))
        if err > TC_TOL:
            raise RuntimeError(f"K1 {shape}: max|Δ| {err} > {TC_TOL}")
        if not torch.equal(out, K.flash_attention(q, k, v, scale)):
            raise RuntimeError(f"K1 {shape}: two launches differ")
        rows.append({
            "shape": list(shape), "max_abs_err": err, "key_splits": d512_split_count(
                torch, q.dtype, b * h, s, s) if d == 512 else 1,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), iters),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters),
            **bound(4.0 * b * h * s * s * d, 4 * 4 * q.numel(), True)})
        print(f"K1 {shape} ({rows[-1]['key_splits']} key splits): max|Δ| {err:.3g}  "
              f"kernel {rows[-1]['ms']:.4f} ms  "
              f"plain {rows[-1]['plain_ms']:.4f} ms  sdpa "
              f"{rows[-1]['library_ms']:.4f} ms  {bound_text(rows[-1])}")
    for sq, sk in ((4100, 4100), (300, 70)):
        q = torch.randn((1, 2, sq, 40), generator=gen, device="cuda")
        k, v = (torch.randn((1, 2, sk, 40), generator=gen, device="cuda") for _ in range(2))
        out = K.flash_attention(q, k, v, 40 ** -0.5)
        torch.cuda.synchronize()
        err = max_err(torch, out, K.flash_attention_plain(q, k, v, 40 ** -0.5))
        if err > TC_TOL:
            raise RuntimeError(f"K1 d=40 Sq={sq} Sk={sk}: max|Δ| {err} > {TC_TOL}")
        print(f"K1 d=40 Sq={sq} Sk={sk}: max|Δ| {err:.3g}")
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


def graph_ms(torch, fn, iters: int) -> float:
    """ms of one call's device work: the call captured in a CUDA graph and
    replayed, so the host's time per call does not enter."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters)


def k2_cases(torch, cfg=None):
    """``[(label, spec, operands, q, k, v, scale)]`` at K2's 13 main-path
    geometries (P, D, K), with the real operands of their controllers: the
    16 cross sites (Replace and Refine) and the 6 self sites inside (step 0,
    α = 1) and outside (step 45, α = 0) the injection window; and the replay
    edit's cross sites at P = 4096 (Replace with Reweight's equalizer). CFG
    batch 4 (one edit row), q/k/v drawn in order from one generator. With
    ``cfg`` (an SD-2.1 or the LDM-256 config), its Replace edit's
    geometries instead: the cross sites at every level and the self sites
    within ``self_max_pixels`` at steps 0 and 45, all at D = 64."""
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
    for m in unet_layout((cfg or SD14).unet).metas:
        metas.setdefault((m.is_cross, m.pixels), m)
    gen = torch.Generator("cuda").manual_seed(2 if cfg is None else 9)
    if cfg is None:
        plan = [(kind, metas[(True, p)], 0) for p in (4096, 1024, 256, 64)
                for kind in ("replace", "refine")]
        plan += [("replace", metas[(False, p)], step) for p in (256, 64)
                 for step in (0, 45)]
        plan += [("reweight", metas[(True, 4096)], 0)]
    else:
        self_max = ctrls["replace"].edit.self_max_pixels
        plan = [("replace", m, 0) for (cross, p), m in metas.items() if cross]
        plan += [("replace", m, step) for (cross, p), m in metas.items()
                 if not cross and p <= self_max for step in (0, 45)]
    cases = []
    for kind, meta, step in plan:
        ctrl = ctrls[kind]
        spec = kernel_edit_spec(ctrl, meta)
        ops = {n: t.contiguous() for n, t in
               edit_operands(ctrl.edit.to("cuda"), spec, step).items()}
        d = meta.channels // meta.heads
        q = torch.randn((4, meta.heads, meta.pixels, d), generator=gen, device="cuda")
        k, v = (torch.randn((4, meta.heads, meta.key_len, d), generator=gen,
                            device="cuda") for _ in range(2))
        label = (f"{'cross' if meta.is_cross else 'self'} {kind} P={meta.pixels} "
                 f"D={d} K={meta.key_len} Kp={spec.pad_len} step={step}")
        if cfg is not None:
            label = f"{cfg.name} {label}"
        cases.append((label, spec, ops, q, k, v, d ** -0.5))
    return cases


def k2_phases(torch, K, F, dtype=None, cfgs=(None,)):
    """K2 at its 13 main-path geometries (:func:`k2_cases`), or at each
    SD-2.1 or LDM-256 config's of ``cfgs``, each twice for bitwise-equal outputs,
    within ``TC_TOL`` (f32) or ``BF16_TOL`` (q, k and v cast to ``dtype``
    bf16) of the plain output's largest magnitude."""
    from p2p_tpu_torch.kernels.fused_edit import fold_operands

    bf16 = dtype is not None
    tag, tol = ("K2 bf16", BF16_TOL) if bf16 else ("K2", TC_TOL)
    rows = []
    cases = [c for cfg in cfgs for c in k2_cases(torch, cfg)]
    for label, spec, ops, q, k, v, scale in cases:
        if bf16:
            q, k, v = (t.to(dtype) for t in (q, k, v))
        out = K.edit_attention(q, k, v, scale, spec, ops)
        torch.cuda.synchronize()
        want = K.edit_attention_plain(q, k, v, scale, spec, ops)
        err = rel_err(torch, out, want, f"{tag} {label}", tol)
        if not torch.equal(out, K.edit_attention(q, k, v, scale, spec, ops)):
            raise RuntimeError(f"{tag} {label}: two launches differ")
        # The work this run's operands need, folded: one pass (q k^T, then
        # p v) for each plain row and for each pass of the edit row that its
        # fold does not skip, and the fold's K x K product; and unfolded as
        # the earlier f32 CUDA-core kernel did it, for comparison: the edit
        # row's own softmax unless α ≡ 1 without transform, its base softmax
        # unless α ≡ 0, its K x K transform, and its p v.
        b_half = q.shape[0] // 2
        c1_zero, c2_zero = (bool(z[0]) for z in fold_operands(v[b_half + 1:], spec, ops)[2:])
        heads, pixels, keys, d = q.shape[1], q.shape[2], spec.key_len, q.shape[3]
        qk = 2.0 * pixels * keys * d
        fold = 2.0 * keys * keys * d if spec.has_transform and not c1_zero else 0.0
        flops = heads * (2 * qk * (b_half + 1 + (not c1_zero) + (not c2_zero)) + fold)
        alpha = ops["blend"][:, :keys]
        zero, one = bool((alpha == 0).all()), bool((alpha == 1).all())
        edit_row = (0 if one and not spec.has_transform else qk) + qk
        if not zero:
            edit_row += qk + (2.0 * pixels * keys ** 2 if spec.has_transform else 0)
        unfolded = heads * (3 * 2 * qk + edit_row)
        nbytes = (q.element_size() * (2 * q.numel() + 2 * k.numel())
                  + 4 * sum(t.numel() for t in ops.values()))
        iters = 20 if pixels >= 1024 else 50
        call = lambda: K.edit_attention(q, k, v, scale, spec, ops)  # noqa: E731
        rows.append({
            "site": label, "max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
            "edit_row_passes": [p for p, z in (("base", c1_zero), ("own", c2_zero)) if not z],
            "ms": cuda_ms(torch, call, iters),
            "device_ms": graph_ms(torch, call, iters),
            "plain_ms": cuda_ms(torch, lambda: K.edit_attention_plain(
                q, k, v, scale, spec, ops), 5),
            "library_ms": None,
            "sdpa_yardstick_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters),
            **bound(flops, nbytes, True, bf16), "flops": flops, "unfolded_flops": unfolded,
            "unfolded_bound_f32_ms": bound(unfolded, nbytes, False)["bound_ms"]})
        r = rows[-1]
        print(f"{tag} {label}: passes {r['edit_row_passes']}  kernel {r['ms']:.4f} ms "
              f"(device {r['device_ms']:.4f})  plain {r['plain_ms']:.4f} ms  sdpa "
              f"yardstick {r['sdpa_yardstick_ms']:.4f} ms  {bound_text(r)}")
    print(f"{tag}: two launches give bitwise-equal outputs at every geometry")
    return rows


def k1_bf16_phases(torch, K, F):
    """K1 in bf16 at d = 40 (flash_fwd_sm90_kernel<40>): the U-Net 64² self
    sites of the bf16 edit,
    (4, 8, 4096, 40), and of the bf16 inversion's forwards without
    gradient, (1, 8, 4096, 40), then the ragged lengths S = 4100 and Sq =
    300 with Sk = 70; each within ``BF16_TOL`` of the bf16 plain version's
    largest magnitude and bitwise-equal across two launches. SDPA in bf16
    is the yardstick; the exponentials' floor stands beside the bound."""
    gen = torch.Generator("cuda").manual_seed(4)
    rows = []
    for shape_q, sk in (((4, 8, 4096, 40), 4096), ((1, 2, 4100, 40), 4100),
                        ((1, 2, 300, 40), 70), ((1, 8, 4096, 40), 4096)):
        b, h, sq, d = shape_q
        q = torch.randn(shape_q, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        scale = d ** -0.5
        label = f"K1 bf16 {shape_q} Sk={sk}"
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = rel_err(torch, out, K.flash_attention_plain(q, k, v, scale), label, BF16_TOL)
        if not torch.equal(out, K.flash_attention(q, k, v, scale)):
            raise RuntimeError(f"{label}: two launches differ")
        if sq != 4096:
            continue
        rows.append({
            "shape": list(shape_q), "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), 20),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), 20),
            **bound(4.0 * b * h * sq * sk * d, 2 * 4 * q.numel(), True, bf16=True)})
        r = rows[-1]
        print(f"{label}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"sdpa bf16 {r['library_ms']:.4f} ms  {bound_text(r)}; ex2 floor "
              f"{ex2_floor_ms(torch, b * h * sq * sk):.4f} ms")
    return rows


def sdpa_times(torch, F, q, k, v, do, scale: float, iters: int):
    """``(backward, forward_and_backward)`` ms of SDPA in q's dtype: the
    backward alone (``torch.autograd.grad`` on a retained forward), which
    computes K4's function, and the two together."""
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    bwd = cuda_ms(torch, lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                     retain_graph=True), iters)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        torch.autograd.grad(o, (qg, kg, vg), do)

    return bwd, cuda_ms(torch, fwd_bwd, iters)


#: The libraries written on Hopper's own instructions (wgmma, TMA), each
#: with its kernels' instantiations: "name" or "name<head dim>".
SM90_LIBRARIES = {"flash_fwd_sm90": ("flash_fwd_sm90_kernel<40>", "flash_fwd_sm90_kernel<64>",
                                     "flash_d512_sm90_kernel"),
                  "flash_bwd_sm90": tuple(f"flash_bwd_{p}_sm90_kernel<{d}>"
                                          for p in ("dkv", "dq") for d in (40, 64)),
                  "flash_bwd_tf32_sm90": ("flash_bwd_dkv_tf32_sm90_kernel",
                                          "flash_bwd_dq_tf32_sm90_kernel"),
                  "flash_fwd_tf32_sm90": ("flash_fwd_tf32_sm90_kernel",)}


#: Kernels of those libraries that are not on wgmma: the d = 512 key
#: split's merge (``csrc/flash_merge.cuh``) and the f32 d = 64 forward's
#: split of K and V.
SM90_PLAIN_KERNELS = {"flash_fwd_sm90": ("flash_merge_kernel",),
                      "flash_fwd_tf32_sm90": ("flash_split_kv_tf32_kernel",)}


def kernel_instance(symbol: str):
    """``"name"`` or ``"name<d>"`` of a kernel's symbol as ptxas or
    cuobjdump print it (mangled, ``...name_kernelILi40EE...``, or
    demangled, ``name_kernel<40>``); None for a symbol of no kernel."""
    import re

    found = re.search(r"_kernel(?:ILi(\d+)E|<(\d+)>)?", symbol)
    start = symbol.rfind("flash_", 0, found.start()) if found else -1
    if start < 0:
        return None
    d = found.group(1) or found.group(2)
    return symbol[start:found.start()] + "_kernel" + (f"<{d}>" if d else "")


def sm90_sass(build, library: str) -> dict:
    """Instruction counts in the SASS of a built library of
    ``SM90_LIBRARIES`` (``cuobjdump -sass``), in all and by kernel
    instantiation (``by_kernel``): raises unless it holds exactly the
    instantiations listed there (and in ``SM90_PLAIN_KERNELS``) and each
    listed in ``SM90_LIBRARIES`` runs on Hopper's wgmma (HGMMA) fed by TMA
    (UTMALDG), with no ``mma.sync`` (HMMA)."""
    import re

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._lib_path(library))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    ops = ("HGMMA", "UTMALDG", "HMMA", "MUFU.EX2")

    def count(text):
        return {op: len(re.findall(rf"\b{op}\b", text)) for op in ops}

    parts = re.split(r"Function : (\S+)", sass)
    by_kernel = {kernel_instance(name): count(body)
                 for name, body in zip(parts[1::2], parts[2::2])}
    counts = {**count(sass), "by_kernel": by_kernel}
    print(f"{library} SASS: {counts}")
    expected = SM90_LIBRARIES[library] + SM90_PLAIN_KERNELS.get(library, ())
    if sorted(by_kernel) != sorted(expected):
        raise RuntimeError(f"{library}: kernels {sorted(by_kernel)}, expected "
                           f"{sorted(expected)}")
    for name, c in by_kernel.items():
        if name in SM90_LIBRARIES[library] and (not c["HGMMA"] or not c["UTMALDG"]
                                                or c["HMMA"]):
            raise RuntimeError(f"{library} {name} is not on wgmma and TMA: {c}")
    return counts


def ptxas_kernels(text: str) -> dict:
    """``{instantiation: {"registers": n, "spill_bytes": n}}`` from the
    ``-Xptxas -v`` report of a build."""
    import re

    out = {}
    for block in re.split(r"Compiling entry function ", text)[1:]:
        name = kernel_instance(block.split()[0])
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", block)
        if name is not None:
            out[name] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_bytes": sum(int(n) for n in spills)}
    return out


def check_no_spills(report: dict) -> dict:
    """Raise if ptxas spilled in a freshly built library of
    ``SM90_LIBRARIES`` (their wgmma accumulators live in registers), or if
    its report lacks one of the library's instantiations. Returns each
    instantiation's registers and spilled bytes."""
    import re

    import re

    kernels = {}
    for name, expected in SM90_LIBRARIES.items():
        if name not in report:
            continue
        text = report[name]["ptxas"]
        # ptxas's note that it serialized a kernel's wgmma (C7515): reported,
        # not a failure.
        serialized = {kernel_instance(f) for f in
                      re.findall(r"C7515\).*?function '([^']+)'", text)}
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        if any(spills):
            raise RuntimeError(f"{name}: ptxas spilled ({spills} bytes)")
        found = ptxas_kernels(text)
        missing = [k for k in expected if k not in found]
        if missing:
            raise RuntimeError(f"{name}: no ptxas report of {missing}")
        for k, v in found.items():
            v["wgmma_serialized"] = k in serialized
        kernels.update(found)
    print(f"sm90 kernels, registers, spilled bytes and serialized wgmma: {kernels}")
    return kernels


def sdpa_bwd_graph_ms(torch, F, q, k, v, do, scale: float, iters: int) -> float:
    """ms of SDPA's backward alone in q's dtype as a replayed CUDA graph:
    the forward runs on the capturing stream, so that autograd runs the
    backward there, and the backward alone is captured."""
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        for _ in range(2):
            torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    return cuda_ms(torch, graph.replay, iters)


def k1_d64_phases(torch, K, F, dtype):
    """K1 at d = 64, SD-2.1's head dim, in ``dtype`` (f32:
    flash_fwd_tf32_sm90_kernel, 3xTF32 on tf32 wgmma, within ``TC_TOL``;
    bf16: flash_fwd_sm90_kernel<64>, within ``BF16_TOL`` of the plain
    output's largest magnitude): the self sites of the 768-v
    edit, (4, 5, 9216, 64) and (4, 10, 2304, 64), and of the 512-base one,
    (4, 5, 4096, 64), then the ragged lengths S = 4100 and Sq = 300 with
    Sk = 70; each bitwise across two launches, the path shapes timed beside
    SDPA in ``dtype``."""
    bf16 = dtype == torch.bfloat16
    tag = "K1 bf16 d=64" if bf16 else "K1 d=64"
    gen = torch.Generator("cuda").manual_seed(10 if bf16 else 11)
    rows = []
    for shape_q, sk in (((4, 5, 9216, 64), 9216), ((4, 10, 2304, 64), 2304),
                        ((4, 5, 4096, 64), 4096), ((1, 2, 4100, 64), 4100),
                        ((1, 2, 300, 64), 70)):
        b, h, sq, d = shape_q
        q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        label = f"{tag} {shape_q} Sk={sk}"
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = K.flash_attention_plain(q, k, v, scale)
        if bf16:
            err = rel_err(torch, out, want, label, BF16_TOL)
        else:
            err = max_err(torch, out, want)
            print(f"  {label}: max|Δ| {err:.3g}")
            if err > TC_TOL:
                raise RuntimeError(f"{label}: max|Δ| {err} > {TC_TOL}")
        if not torch.equal(out, K.flash_attention(q, k, v, scale)):
            raise RuntimeError(f"{label}: two launches differ")
        if b == 1:
            continue
        rows.append({
            "shape": list(shape_q), "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), 10),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 2),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), 10),
            **bound(4.0 * b * h * sq * sk * d, 4 * q.element_size() * q.numel(), True, bf16)})
        r = rows[-1]
        print(f"{label}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  sdpa "
              f"{r['library_ms']:.4f} ms  {bound_text(r)}")
    return rows


def k34_d64_phases(torch, K, F, dtype):
    """K3 (forward with residuals) and both K4 passes at d = 64, SD-2.1's
    gradient sites, in ``dtype``: 768-v's (1, 5, 9216, 64) and (1, 10,
    2304, 64) and 512-base's (1, 5, 4096, 64), then the ragged lengths S =
    4100, Sq = 300 with Sk = 70 and Sq = 70 with Sk = 300. Outputs and
    gradients within ``TC_TOL`` (f32: flash_fwd_tf32_sm90_kernel,
    flash_bwd_{dkv,dq}_tf32_sm90_kernel, all 3xTF32 on tf32 wgmma) or ``BF16_TOL`` (bf16:
    flash_fwd_sm90_kernel<64> and flash_bwd_{dkv,dq}_sm90_kernel) of the plain
    versions' largest magnitude, K3's f32 ``m`` and ``l`` within ``TC_TOL``
    relative, each bitwise across two launches; the K4 passes take the
    plain forward's residuals. The path shapes are timed beside the plain
    versions, the bound and SDPA in ``dtype``: forward for K3, the backward
    alone for K4 (``library_ms``; forward and backward together in
    ``sdpa_fwd_bwd_ms``); K4 and SDPA's backward also as replayed CUDA
    graphs (``graph_ms``, ``library_graph_ms``), their device time without
    the host's. Returns ``{"K3" | "K4_dkv" | "K4_dq": rows}``."""
    bf16 = dtype == torch.bfloat16
    tol, tag = (BF16_TOL, "bf16 d=64") if bf16 else (TC_TOL, "d=64")
    gen = torch.Generator("cuda").manual_seed(15 if bf16 else 16)
    rows = {"K3": [], "K4_dkv": [], "K4_dq": []}
    for shape_q, sk in (((1, 5, 9216, 64), 9216), ((1, 10, 2304, 64), 2304),
                        ((1, 5, 4096, 64), 4096), ((1, 2, 4100, 64), 4100),
                        ((1, 2, 300, 64), 70), ((1, 2, 70, 64), 300)):
        b, h, sq, d = shape_q
        q, do = (torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        label = f"{shape_q} Sk={sk}"
        got = K.flash_attention_residuals(q, k, v, scale)
        torch.cuda.synchronize()
        want = K.flash_attention_residuals_plain(q, k, v, scale)
        err3 = rel_err(torch, got[0], want[0], f"K3 {tag} {label} out", tol)
        for name, a, w in zip(("l", "m"), got[1:], want[1:]):
            rel_err(torch, a, w, f"K3 {tag} {label} {name}", TC_TOL)
        if not all(torch.equal(a, b2) for a, b2 in zip(
                got, K.flash_attention_residuals(q, k, v, scale))):
            raise RuntimeError(f"K3 {tag} {label}: two launches differ")
        o, l, m = want
        di = (o.float() * do.float()).sum(dim=-1)
        dk, dv = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
        dq = K.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale)
        torch.cuda.synchronize()
        if not all(t.dtype == dtype for t in (dq, dk, dv)):
            raise RuntimeError(f"K4 {tag} {label}: gradients {dq.dtype}, {dk.dtype}, "
                               f"{dv.dtype}")
        p_dk, p_dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
        p_dq = K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)
        err_dkv = max(rel_err(torch, dk, p_dk, f"K4 {tag} {label} dk", tol),
                      rel_err(torch, dv, p_dv, f"K4 {tag} {label} dv", tol))
        err_dq = rel_err(torch, dq, p_dq, f"K4 {tag} {label} dq", tol)
        dk2, dv2 = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
        dq2 = K.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale)
        for name, a, b2 in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
            if not torch.equal(a, b2):
                raise RuntimeError(f"K4 {tag} {label} {name}: two launches differ")
        if h == 2:                               # ragged: checked, not timed
            continue
        sdpa_bwd_ms, sdpa_fb_ms = sdpa_times(torch, F, q, k, v, do, scale, 5)
        n = q.element_size() * q.numel()         # bytes of one (B, H, S, D) tensor
        stats = 4 * b * h * sq                   # bytes of one (B, H, S) f32 tensor
        flops = 2.0 * b * h * sq * sk * d        # one S x S x d product
        iters = 5 if sq == 9216 else 10
        common = {"shape": list(shape_q)}
        sdpa_graph = {"library_graph_ms": sdpa_bwd_graph_ms(torch, F, q, k, v, do, scale,
                                                            iters)}
        rows["K3"].append({**common, "max_abs_err": err3,
                           "ms": cuda_ms(torch, lambda: K.flash_attention_residuals(
                               q, k, v, scale), iters),
                           "plain_ms": cuda_ms(torch, lambda: K.flash_attention_residuals_plain(
                               q, k, v, scale), 2),
                           "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                               q, k, v, scale=scale), iters),
                           **bound(2 * flops, 4 * n + 2 * stats, True, bf16)})
        rows["K4_dkv"].append({**common, "max_abs_err": err_dkv,
                               "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv(
                                   q, k, v, do, l, m, di, scale), iters),
                               "graph_ms": graph_ms(torch, lambda: K.flash_attention_bwd_dkv(
                                   q, k, v, do, l, m, di, scale), iters), **sdpa_graph,
                               "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv_plain(
                                   q, k, v, do, l, m, di, scale), 2),
                               "library_ms": sdpa_bwd_ms, "sdpa_fwd_bwd_ms": sdpa_fb_ms,
                               **bound(4 * flops, 6 * n + 3 * stats, True, bf16)})
        rows["K4_dq"].append({**common, "max_abs_err": err_dq,
                              "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq(
                                  q, k, v, do, l, m, di, scale), iters),
                              "graph_ms": graph_ms(torch, lambda: K.flash_attention_bwd_dq(
                                  q, k, v, do, l, m, di, scale), iters), **sdpa_graph,
                              "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq_plain(
                                  q, k, v, do, l, m, di, scale), 2),
                              "library_ms": sdpa_bwd_ms, "sdpa_fwd_bwd_ms": sdpa_fb_ms,
                              **bound(3 * flops, 5 * n + 3 * stats, True, bf16)})
        for name in rows:
            r = rows[name][-1]
            graphs = ("" if name == "K3" else f" (graph {r['graph_ms']:.4f} / sdpa bwd graph "
                      f"{r['library_graph_ms']:.4f})")
            print(f"{name} {tag} {label}: max|Δ| {r['max_abs_err']:.3g}  kernel "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  sdpa "
                  f"{'fwd' if name == 'K3' else 'bwd'} {r['library_ms']:.4f} ms{graphs}  "
                  f"{bound_text(r)}")
    print(f"K3/K4 {tag}: two launches give bitwise-equal outputs at every geometry")
    return rows


def window_sum_phase(torch, K):
    """The bf16 sums of the norms' backward at the bf16 inversions' shapes,
    each a view of the port's NCHW cotangent in the JAX package's NHWC
    order as the backward hands it over: a group norm's mean over (pixels,
    channels of a group) and its inverse deviation and shift over the
    pixels, at 64² x 320 channels and 8² x 1280 (SD-1.4) and at 96² x 320
    and 48² x 640 (SD-2.1 768-v), and a layer norm's statistics over the
    channels, 320 and 1280 (SD-1.4) and 320, 640 and 1280 at 9216, 2304 and
    576 tokens (768-v). Bitwise equal to the plain version (the same adds
    in the same order) and across two launches; timed beside ``torch.sum``
    in bf16, which accumulates in f32."""
    gen = torch.Generator("cuda").manual_seed(13)
    rows = []
    for shape, dims in (((1, 32, 10, 64, 64), (1, 2, 4)), ((1, 32, 10, 64, 64), (1, 2)),
                        ((1, 32, 40, 8, 8), (1, 2, 4)), ((1, 4096, 320), (2,)),
                        ((1, 64, 1280), (2,)),
                        ((1, 32, 10, 96, 96), (1, 2, 4)), ((1, 32, 10, 96, 96), (1, 2)),
                        ((1, 32, 20, 48, 48), (1, 2, 4)), ((1, 32, 20, 48, 48), (1, 2)),
                        ((1, 9216, 320), (2,)), ((1, 2304, 640), (2,)),
                        ((1, 576, 1280), (2,))):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        if x.dim() == 5:
            x = x.permute(0, 3, 4, 1, 2)
        tag = f"window sum {tuple(x.shape)} over {dims}"
        got = K.window_sum(x, dims)
        torch.cuda.synchronize()
        want = K.window_sum_plain(x, dims)
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            raise RuntimeError(f"{tag}: differs from its plain version "
                               f"(max|Δ| {max_err(torch, got, want)})")
        if not torch.equal(got, K.window_sum(x, dims)):
            raise RuntimeError(f"{tag}: two launches differ")
        row = {"shape": list(x.shape), "dims": list(dims), "max_abs_err": 0.0,
               "ms": cuda_ms(torch, lambda: K.window_sum(x, dims), 20),
               "plain_ms": cuda_ms(torch, lambda: K.window_sum_plain(x, dims), 1, 1),
               "library_ms": cuda_ms(torch, lambda: torch.sum(x, dims, keepdim=True), 20),
               **bound(x.numel(), 2 * x.numel() + 2 * got.numel(), False)}
        print(f"{tag}: bitwise; kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
              f"torch.sum {row['library_ms']:.4f} ms  {bound_text(row)}")
        rows.append(row)
    return rows


def gradient_window_sums(torch, K, pipe, dtype) -> int:
    """Launches of the norms' backward sums in one null-text gradient of
    ``pipe``'s U-Net in ``dtype``, at the first outer step, on its own."""
    from p2p_tpu_torch.engine.inversion import null_text_loss
    from p2p_tpu_torch.engine.sampler import encode_prompts
    from p2p_tpu_torch.models.unet import apply_unet
    from p2p_tpu_torch.ops.schedulers import schedule_from_config

    sched = schedule_from_config(STEPS, pipe.config.scheduler, kind="ddim", device="cuda")
    t = sched.timesteps.tolist()[0]
    gen = torch.Generator("cuda").manual_seed(14)
    latent, target = (torch.randn((1,) + pipe.latent_shape, generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
    with torch.no_grad():
        cond = encode_prompts(pipe, [PROMPTS[0]], dtype)
        u = encode_prompts(pipe, [""], dtype).float()
        eps_cond, _ = apply_unet(pipe.weights(dtype)[0], pipe.config.unet, latent, t, cond)
    K.reset_launch_counts()
    u.requires_grad_(True)
    torch.autograd.grad(null_text_loss(pipe, sched, latent, t, u, eps_cond, target,
                                       pipe.config.guidance_scale), u)
    torch.cuda.synchronize()
    return K.bf16_launch_counts()["window_sum_bf16"]


def rel_err(torch, got, want, what: str, tol: float) -> float:
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
    err3 = max(rel_err(torch, out, p_out, "K3 out", TC_TOL),
               rel_err(torch, l, p_l, "K3 l", TC_TOL),
               rel_err(torch, m, p_m, "K3 m", TC_TOL))
    again = K.flash_attention_residuals(q, k, v, scale)
    if not all(torch.equal(a, b2) for a, b2 in zip((out, l, m), again)):
        raise RuntimeError("K3: two launches differ")
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
            rel_err(torch, a, w, f"K3/K4 Sq={sq} Sk={sk} {name}", TC_TOL)
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
                  **bound(2 * flops, 4 * n + 2 * stats, True)}
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


def k34_bf16_phases(torch, K, F):
    """K3 and both K4 passes in bf16 at the U-Net 64² self sites under the
    bf16 inversion's gradient, (1, 8, 4096, 40), then at the ragged lengths
    S = 4100, Sq = 300 with Sk = 70 and Sq = 70 with Sk = 300: outputs and
    gradients within ``BF16_TOL`` of the bf16 plain versions' largest
    magnitude (K3: flash_fwd_sm90_kernel<40>; K4:
    flash_bwd_{dkv,dq}_sm90_kernel<40>), K3's f32 ``m`` and
    ``l`` within ``TC_TOL`` relative, each bitwise across two launches.
    The K4 passes take the plain forward's residuals. SDPA in bf16 is the
    yardstick: forward for K3, the backward alone for K4 (with
    forward and backward together in ``sdpa_fwd_bwd_ms``); K4 and SDPA's
    backward also as replayed CUDA graphs (``graph_ms``,
    ``library_graph_ms``), since SDPA's eager backward at this shape reads
    the host more than the device."""
    gen = torch.Generator("cuda").manual_seed(5)
    bf16 = torch.bfloat16
    rows = {}
    for shape_q, sk in (((1, 8, 4096, 40), 4096), ((1, 2, 4100, 40), 4100),
                        ((1, 2, 300, 40), 70), ((1, 2, 70, 40), 300)):
        b, h, sq, d = shape_q
        q, do = (torch.randn(shape_q, generator=gen, device="cuda").to(bf16)
                 for _ in range(2))
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(bf16)
                for _ in range(2))
        scale = d ** -0.5
        tag = f"{shape_q} Sk={sk}"
        got = K.flash_attention_residuals(q, k, v, scale)
        torch.cuda.synchronize()
        want = K.flash_attention_residuals_plain(q, k, v, scale)
        err3 = rel_err(torch, got[0], want[0], f"K3 bf16 {tag} out", BF16_TOL)
        for name, a, w in zip(("l", "m"), got[1:], want[1:]):
            rel_err(torch, a, w, f"K3 bf16 {tag} {name}", TC_TOL)
        again = K.flash_attention_residuals(q, k, v, scale)
        if not all(torch.equal(a, b2) for a, b2 in zip(got, again)):
            raise RuntimeError(f"K3 bf16 {tag}: two launches differ")
        o, l, m = want
        di = (o.float() * do.float()).sum(dim=-1)
        dk, dv = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
        dq = K.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale)
        torch.cuda.synchronize()
        p_dk, p_dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
        p_dq = K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)
        if not all(t.dtype == bf16 for t in (dq, dk, dv)):
            raise RuntimeError(f"K4 bf16 {tag}: gradients {dq.dtype}, {dk.dtype}, {dv.dtype}")
        err_dkv = max(rel_err(torch, dk, p_dk, f"K4 bf16 {tag} dk", BF16_TOL),
                      rel_err(torch, dv, p_dv, f"K4 bf16 {tag} dv", BF16_TOL))
        err_dq = rel_err(torch, dq, p_dq, f"K4 bf16 {tag} dq", BF16_TOL)
        dk2, dv2 = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
        dq2 = K.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale)
        for name, a, b2 in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
            if not torch.equal(a, b2):
                raise RuntimeError(f"K4 bf16 {tag} {name}: two launches differ")
        if sq != 4096:
            continue
        sdpa_bwd_ms, sdpa_fb_ms = sdpa_times(torch, F, q, k, v, do, scale, 10)
        sdpa_graph = {"library_graph_ms": sdpa_bwd_graph_ms(torch, F, q, k, v, do, scale,
                                                            20)}
        n = 2 * q.numel()                        # bytes of one (B, H, S, D) bf16 tensor
        stats = 4 * b * h * sq                   # bytes of one (B, H, S) f32 tensor
        flops = 2.0 * b * h * sq * sk * d        # one S x S x d product
        rows["K3"] = {"shape": list(shape_q), "max_abs_err": err3,
                      "ms": cuda_ms(torch, lambda: K.flash_attention_residuals(
                          q, k, v, scale), 20),
                      "plain_ms": cuda_ms(torch, lambda: K.flash_attention_residuals_plain(
                          q, k, v, scale), 3),
                      "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                          q, k, v, scale=scale), 20),
                      **bound(2 * flops, 4 * n + 2 * stats, True, bf16=True)}
        k3_ex2_ms = ex2_floor_ms(torch, b * h * sq * sk)
        rows["K4_dkv"] = {"shape": list(shape_q), "max_abs_err": err_dkv,
                          "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv(
                              q, k, v, do, l, m, di, scale), 20),
                          "graph_ms": graph_ms(torch, lambda: K.flash_attention_bwd_dkv(
                              q, k, v, do, l, m, di, scale), 20), **sdpa_graph,
                          "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dkv_plain(
                              q, k, v, do, l, m, di, scale), 3),
                          "library_ms": sdpa_bwd_ms, "sdpa_fwd_bwd_ms": sdpa_fb_ms,
                          **bound(4 * flops, 6 * n + 3 * stats, True, bf16=True)}
        rows["K4_dq"] = {"shape": list(shape_q), "max_abs_err": err_dq,
                         "ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq(
                             q, k, v, do, l, m, di, scale), 20),
                         "graph_ms": graph_ms(torch, lambda: K.flash_attention_bwd_dq(
                             q, k, v, do, l, m, di, scale), 20), **sdpa_graph,
                         "plain_ms": cuda_ms(torch, lambda: K.flash_attention_bwd_dq_plain(
                             q, k, v, do, l, m, di, scale), 3),
                         "library_ms": sdpa_bwd_ms, "sdpa_fwd_bwd_ms": sdpa_fb_ms,
                         **bound(3 * flops, 5 * n + 3 * stats, True, bf16=True)}
    for name, r in rows.items():
        graphs = ("" if name == "K3" else f" (graph {r['graph_ms']:.4f} / sdpa bwd graph "
                  f"{r['library_graph_ms']:.4f})")
        print(f"{name} bf16 {r['shape']}: max|Δ| {r['max_abs_err']:.3g}  kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  sdpa bf16 "
              f"{'bwd ' if name != 'K3' else ''}{r['library_ms']:.4f} ms{graphs}  "
              f"{bound_text(r)}" + (f"; ex2 floor {k3_ex2_ms:.4f} ms" if name == "K3" else ""))
    print("K3/K4 bf16: two launches give bitwise-equal outputs at every geometry")
    return rows


def k1_d512_bf16_phases(torch, K, F):
    """K1 in bf16 at d = 512 (``flash_d512_sm90_kernel``: wgmma and TMA,
    with the key split ``kernels.flash.d512_splits`` gives each call and
    its merge): the bf16 VAE encode of the inversion, (1, 1, 4096, 512)
    and, at SD-2.1 768-v, (1, 1, 9216, 512), then the ragged lengths S =
    4100 and Sq = 300 with Sk = 70 (also with K3's residuals there); within
    ``BF16_TOL`` of the bf16 plain version's largest magnitude (the
    residuals within ``TC_TOL``), bitwise across two launches; timed with
    its merge (if any) beside SDPA in bf16 and the bound. Then q = k at
    (1, 1, 9216, 512) and (1, 1, 300, 512): each row's own key dominates, so
    a row reads essentially one row of V, and a K or V chunk read from the
    wrong stage of the kernel's ring would miss by O(1), not by a rounding;
    held within ``BF16_TOL`` too."""
    gen = torch.Generator("cuda").manual_seed(6)
    rows = []
    d = 512
    for s in (9216, 300):
        k = torch.randn((1, 1, s, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((1, 1, s, d), generator=gen, device="cuda").bfloat16()
        rel_err(torch, K.flash_attention(k, k, v, d ** -0.5),
                K.flash_attention_plain(k, k, v, d ** -0.5),
                f"K1 bf16 d=512 q = k, S={s} ({d512_split_count(torch, torch.bfloat16, 1, s, s)} "
                "key splits)", BF16_TOL)
    for sq, sk in ((4096, 4096), (4100, 4100), (300, 70), (9216, 9216)):
        q = torch.randn((1, 1, sq, d), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((1, 1, sk, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        scale = d ** -0.5
        n = d512_split_count(torch, torch.bfloat16, 1, sq, sk)
        label = f"K1 bf16 d=512 Sq={sq} Sk={sk} ({n} key splits)"
        out = K.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = rel_err(torch, out, K.flash_attention_plain(q, k, v, scale), label, BF16_TOL)
        if not torch.equal(out, K.flash_attention(q, k, v, scale)):
            raise RuntimeError(f"{label}: two launches differ")
        if sq not in (4096, 9216):
            got = K.flash_attention_residuals(q, k, v, scale)
            torch.cuda.synchronize()
            want = K.flash_attention_residuals_plain(q, k, v, scale)
            rel_err(torch, got[0], want[0], f"K3 bf16 d=512 Sq={sq} Sk={sk} out", BF16_TOL)
            for name, a, w in zip(("l", "m"), got[1:], want[1:]):
                rel_err(torch, a, w, f"K3 bf16 d=512 Sq={sq} Sk={sk} {name}", TC_TOL)
            if not all(torch.equal(a, b) for a, b in zip(
                    got, K.flash_attention_residuals(q, k, v, scale))):
                raise RuntimeError(f"K3 {label}: two launches differ")
            continue
        rows.append({
            "shape": [1, 1, sq, d], "max_abs_err": err, "key_splits": n,
            "ms": cuda_ms(torch, lambda: K.flash_attention(q, k, v, scale), 20),
            "plain_ms": cuda_ms(torch, lambda: K.flash_attention_plain(q, k, v, scale), 3),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), 20),
            **bound(4.0 * sq * sk * d, 2 * 4 * q.numel(), True, bf16=True)})
        r = rows[-1]
        print(f"{label}: kernel {r['ms']:.4f} ms (merge included)  plain "
              f"{r['plain_ms']:.4f} ms  sdpa bf16 {r['library_ms']:.4f} ms  {bound_text(r)}")
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
            "fused_edit": STEPS * 22, "fused_edit_fold": STEPS * 22,
            "flash_merge": vae_merges(torch, pipe, 2)}
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

    # The same edit in bf16: K1 at d = 40 and K2 in bf16, the VAE decode in
    # f32 (its K1 at d = 512 in f32).
    def run16(kernels):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, PROMPTS, ctrl, num_steps=STEPS,
                                    latent=x_t, kernels=kernels, device="cuda",
                                    return_latents=True, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    run16(KernelConfig())                    # warm-up: bf16 weights, cuDNN
    K.reset_launch_counts()
    img16, lat16, secs16 = run16(KernelConfig())
    counts16 = path_counts(K)
    want16 = {**dict.fromkeys(counts16, 0), "flash_attn_bf16": STEPS * 5,
              "flash_attn": 1, "fused_edit_bf16": STEPS * 22,
              "fused_edit_fold_bf16": STEPS * 22, "flash_merge": vae_merges(torch, pipe, 2)}
    if counts16 != want16:
        raise RuntimeError(f"bf16 launch counts {counts16}, expected {want16}")
    if (img16.shape != (2, 512, 512, 3) or lat16.dtype != torch.bfloat16
            or not bool(torch.isfinite(lat16).all())):
        raise RuntimeError(f"bf16 images {tuple(img16.shape)} or latents "
                           f"{lat16.dtype} non-finite")
    _, lat16_ref, secs16_ref = run16(None)
    print(f"main path bf16: launches {counts16}")
    drift16 = bf16_drift(torch, "main path bf16", lat16, lat16_ref, lat_ref)
    print(f"main path bf16: {secs16:.3f} s per image pair with kernels "
          f"({secs16 / STEPS * 1e3:.2f} ms per step), {secs16_ref:.3f} s with "
          f"kernels=None; f32 {secs:.3f} s")
    return counts, counts16, {
        "s_per_pair": secs, "s_per_pair_materialized": secs_ref,
        "latent_drift": drift, "ms_per_step": secs / STEPS * 1e3,
        "bf16": {"s_per_pair": secs16, "s_per_pair_materialized": secs16_ref,
                 "ms_per_step": secs16 / STEPS * 1e3, **drift16}}


def inversion_path(torch, K, pipe, dtype=None, steps=STEPS, tag=None):
    """``invert`` of ``pipe`` (SD-1.4 or SD-2.1 768-v) at full width, with
    ``steps`` outer steps and the reference's other defaults, on a seeded
    uint8 image of the config's size, in f32 or, with ``dtype`` bf16, in
    bf16. The launch counts follow from the layout and the inner iterations
    n the early stop left: every forward without gradient runs K1 at the
    self sites of 2048 pixels or more (SD-1.4: 5 at 64²; 768-v: 5 at 96²
    and 5 at 48²); in an inner iteration's forward the site before the
    first cross site does not see the embedding and runs K1 too, while the
    others (SD-1.4: 4; 768-v: 9) run K3, and the backward runs K4's two
    passes at each of those; the VAE encode and the reconstruction's decode
    run K1 at d = 512. In bf16 all of those are the bf16 kernels but the
    decode's, which runs in f32. The counts are held by kernel and by head
    dim (``kernels.head_dim_launch_counts``)."""
    bf16 = dtype is not None
    tag = tag or ("inversion bf16" if bf16 else "inversion")
    import numpy as np

    from p2p_tpu_torch.engine import inversion as inv
    from p2p_tpu_torch.models.config import unet_layout

    metas = unet_layout(pipe.config.unet).metas
    first_cross = min(m.layer_idx for m in metas if m.is_cross)
    big = [m for m in metas if not m.is_cross and m.pixels >= 2048]
    n_const = sum(1 for m in big if m.layer_idx < first_cross)
    n_grad = len(big) - n_const
    (d,) = {m.channels // m.heads for m in big}
    cfg = pipe.config
    dv = vae_head_dim(cfg)
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

    per_gradient = gradient_window_sums(torch, K, pipe, dtype) if bf16 else 0
    if bf16 and per_gradient == 0:
        raise RuntimeError(f"{tag}: a bf16 gradient launched no window sum")
    originals = {name: timed(name) for name in ("ddim_invert", "null_optimize")}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        art = inv.invert(pipe, image, PROMPTS[0], num_steps=steps,
                         num_inner_steps=INNER_STEPS, early_stop_epsilon=EARLY_STOP,
                         dtype=dtype or torch.float32, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(inv, name, fn)
    counts = path_counts(K)
    peak = torch.cuda.max_memory_allocated()
    n = sum(art.inner_steps)
    # inversion, cond + advance forwards and inner forwards; then the VAE
    # encode and the reconstruction's decode
    forwards = steps * len(big) + steps * 2 * len(big) + n * n_const
    want = dict.fromkeys(counts, 0)
    dt = "bf16" if bf16 else "f32"
    want_dims = {f"K1 {dt} d={d}": forwards, f"K3 {dt} d={d}": n * n_grad,
                 f"K4 dkv {dt} d={d}": n * n_grad, f"K4 dq {dt} d={d}": n * n_grad}
    if bf16:
        want.update({"flash_attn_bf16": forwards + 1, "flash_attn": 1,
                     "flash_attn_residuals_bf16": n * n_grad,
                     "flash_attn_bwd_dq_bf16": n * n_grad,
                     "flash_attn_bwd_dkv_bf16": n * n_grad,
                     "window_sum_bf16": n * per_gradient})
        want_dims.update({f"K1 bf16 d={dv}": 1, f"K1 f32 d={dv}": 1})
    else:
        want.update({"flash_attn": forwards + 2, "flash_attn_residuals": n * n_grad,
                     "flash_attn_bwd_dq": n * n_grad, "flash_attn_bwd_dkv": n * n_grad})
        want_dims[f"K1 f32 d={dv}"] = 2
    # the encode in the inversion's dtype, the reconstruction's decode in f32
    want["flash_merge"] = vae_merges(torch, pipe, 1, dtype) + vae_merges(torch, pipe, 1)
    want["flash_split"] = split_passes(want_dims)
    dims = K.head_dim_launch_counts()
    if counts != want or dims != want_dims:
        raise RuntimeError(f"{tag} launch counts {counts} {dims}, expected {want} "
                           f"{want_dims}")
    if art.uncond_embeddings.shape != (steps, 1, cfg.text.max_length,
                                       cfg.text.hidden_dim):
        raise RuntimeError(f"embeddings {art.uncond_embeddings.shape}")
    if not (np.isfinite(art.uncond_embeddings).all() and np.isfinite(art.x_t).all()):
        raise RuntimeError(f"non-finite {tag} output")
    if art.x_t.dtype != np.float32 or (bf16 and not np.array_equal(
            art.x_t, torch.from_numpy(art.x_t).bfloat16().float().numpy())):
        raise RuntimeError(f"{tag}: x_T {art.x_t.dtype} does not hold its compute dtype's values")
    stats = {"s_total": total, "s_ddim_invert": seconds["ddim_invert"],
             "s_null_optimize": seconds["null_optimize"], "inner_iterations": n,
             "ms_per_inner_iteration": seconds["null_optimize"] / n * 1e3,
             "inner_steps": art.inner_steps, "max_memory_allocated": peak,
             "launches": counts, "launches_by_head_dim": dims,
             "grad_sites": n_grad, "window_sum_launches_per_gradient": per_gradient}
    print(f"{tag}: {total:.3f} s ({seconds['ddim_invert']:.3f} s DDIM "
          f"inversion, {seconds['null_optimize']:.3f} s optimization); {n} inner "
          f"iterations, {stats['ms_per_inner_iteration']:.2f} ms each (cond and "
          f"advance forwards included); peak memory {peak / 2**30:.2f} GiB")
    print(f"{tag}: launches {counts}; inner steps {art.inner_steps}")
    return art, image, stats


def replay_path(torch, K, pipe, art, image, dtype=None, f32_latents=None, tag=None,
                f32_reference=False):
    """The replay edit of the inversion: Replace + LocalBlend + Reweight with
    the optimized embeddings, with and without the kernels, and the source
    row's reconstruction against the raw ``""`` uncond; as many steps as the
    artifact has, LocalBlend at a quarter of the latent side (16 at SD-1.4,
    24 at SD-2.1 768-v). With ``dtype`` bf16, the same in bf16 (the
    artifact's embeddings cast at each step): its kernels are the bf16 K1
    and K2, its VAE decode the f32 K1; given the f32 materialized replay's
    latents ``f32_latents``, or with ``f32_reference`` the f32 materialized
    replay of this artifact run here, its drift is held as the main path's
    (:func:`bf16_drift`). Launch counts are held by kernel and by head dim.
    Returns the launch counts, the materialized run's latents and the
    numbers."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = tag or ("replay bf16" if bf16 else "replay")
    from p2p_tpu_torch import KernelConfig, make_controller, text2image
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models import vae as vae_mod
    from p2p_tpu_torch.models.config import unet_layout

    steps = art.num_steps
    prompts = [art.prompt, PROMPTS[1]]
    ctrl = make_controller(prompts, True, 0.8, 0.4, pipe.tokenizer, steps,
                           blend_words=BLEND_WORDS, equalizer_params=EQUALIZER,
                           blend_resolution=pipe.config.latent_size // 4)
    metas = unet_layout(pipe.config.unet).metas
    variants = [site_variant(KernelConfig(), ctrl, m) for m in metas]
    n_k2 = variants.count("fused-edit")
    k1_sites = [m for v, m in zip(variants, metas) if v == "flash" and m.pixels >= 2048]
    n_k1 = len(k1_sites)
    (d,) = {m.channels // m.heads for m in k1_sites}
    x_t = torch.from_numpy(art.x_t).cuda()
    ups = torch.from_numpy(art.uncond_embeddings).cuda()

    def run(kernels, uncond, dtype=dtype):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, prompts, ctrl, num_steps=steps, latent=x_t,
                                    uncond_embeddings=uncond, kernels=kernels,
                                    device="cuda", return_latents=True, dtype=dtype)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    if f32_reference:
        f32_latents = run(None, ups, torch.float32)[1]
    K.reset_launch_counts()
    img, lat, secs = run(KernelConfig(), ups)
    counts = path_counts(K)
    dims = K.head_dim_launch_counts()
    if bf16:
        want = {**dict.fromkeys(counts, 0), "flash_attn_bf16": steps * n_k1,
                "flash_attn": 1, "fused_edit_bf16": steps * n_k2,
                "fused_edit_fold_bf16": steps * n_k2}
        want_dims = {f"K1 bf16 d={d}": steps * n_k1, f"K1 f32 d={vae_head_dim(pipe.config)}": 1}
    else:
        want = {**dict.fromkeys(counts, 0), "flash_attn": steps * n_k1 + 1,
                "fused_edit": steps * n_k2, "fused_edit_fold": steps * n_k2}
        want_dims = {f"K1 f32 d={d}": steps * n_k1, f"K1 f32 d={vae_head_dim(pipe.config)}": 1}
    want["flash_merge"] = vae_merges(torch, pipe, 2)
    want["flash_split"] = split_passes(want_dims)
    if counts != want or dims != want_dims:
        raise RuntimeError(f"{tag} launch counts {counts} {dims}, expected {want} "
                           f"{want_dims}")
    size = pipe.config.image_size
    if img.shape != (2, size, size, 3) or not bool(torch.isfinite(lat).all()):
        raise RuntimeError(f"{tag} images {tuple(img.shape)} or non-finite latents")
    _, lat_ref, secs_ref = run(None, ups)
    if bf16 and f32_latents is not None:
        stats = bf16_drift(torch, tag, lat, lat_ref, f32_latents)
    elif bf16:
        stats = {"latent_drift": max_err(torch, lat, lat_ref),
                 "latent_drift_rms": rms_err(torch, lat, lat_ref)}
    else:
        stats = {"latent_drift": max_err(torch, lat, lat_ref)}
        if stats["latent_drift"] > DRIFT_TOL:
            raise RuntimeError(f"{tag} latents drift {stats['latent_drift']} > {DRIFT_TOL}")
    _, lat_raw, _ = run(KernelConfig(), None)
    with torch.no_grad():
        target = vae_mod.encode(pipe.vae, pipe.config.vae, torch.from_numpy(
            image.astype("float32") / 127.5 - 1.0)[None].cuda())
    err_opt = torch.mean((lat[0].float() - target[0]) ** 2).item()
    err_raw = torch.mean((lat_raw[0].float() - target[0]) ** 2).item()
    if not err_opt < err_raw:
        raise RuntimeError(f"{tag}: null-text invariant: source-row MSE to the "
                           f"encoded image {err_opt} with the optimized "
                           f"embeddings, {err_raw} with the raw uncond")
    print(f"{tag}: launches {counts} ({n_k1} K1 and {n_k2} K2 sites); latents "
          f"max|Δ| vs kernels=None {stats['latent_drift']:.3g}; {secs:.3f} s with "
          f"kernels, {secs_ref:.3f} s without")
    print(f"{tag}: source-row MSE to the encoded image {err_opt:.6g} optimized "
          f"vs {err_raw:.6g} raw uncond")
    return counts, lat_ref, {"s_per_pair": secs, "s_per_pair_materialized": secs_ref,
                             "mse_optimized": err_opt, "mse_raw": err_raw, **stats}


def sd21_path(torch, K, pipe):
    """The SD-2.1 768-v edit (``models/config.py:SD21``: 96² latent,
    v-prediction, the 23-layer gelu text tower, head_dim 64) at full width
    and depth from ``pipe``'s random weights of seed 0: 2 prompts, DDIM 50 steps, CFG
    7.5, ``attention_replace(..., 0.8, 0.4)``, in f32 and in bf16, each with
    ``kernels=KernelConfig()`` and with ``kernels=None``. The launch counts
    follow from the layout: K1 at d = 64 at every untouched self site of at
    least 2048 pixels and K2 (with its fold) at every fused-edit site, a
    step; one f32 K1 at d = 512 for the VAE decode (f32 in the bf16 run
    too). f32: final latents within ``DRIFT_TOL`` of the materialized run;
    bf16: the drift held as the SD-1.4 bf16 edit's (:func:`bf16_drift`)."""
    from p2p_tpu_torch import KernelConfig, attention_replace, text2image
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models.config import SD21, unet_layout

    ctrl = attention_replace(PROMPTS, STEPS, 0.8, 0.4, pipe.tokenizer, store=False)
    metas = unet_layout(SD21.unet).metas
    variants = [site_variant(KernelConfig(), ctrl, m) for m in metas]
    n_k2 = variants.count("fused-edit")
    n_k1 = sum(1 for v, m in zip(variants, metas) if v == "flash" and m.pixels >= 2048)
    size = SD21.latent_size
    x_t = torch.randn((1, size, size, 4), generator=torch.Generator("cuda").manual_seed(8191),
                      device="cuda")

    def run(kernels, dtype, steps=STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, PROMPTS, ctrl, num_steps=steps, latent=x_t,
                                    kernels=kernels, device="cuda", return_latents=True,
                                    dtype=dtype)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    stats, counts = {}, {}
    lat_ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tag = "sd21 bf16" if bf16 else "sd21"
        run(KernelConfig(), dtype, steps=2)          # warm-up: weights, cuDNN
        K.reset_launch_counts()
        img, lat, secs = run(KernelConfig(), dtype)
        c = path_counts(K)
        dims = K.head_dim_launch_counts()
        if bf16:
            want = {**dict.fromkeys(c, 0), "flash_attn_bf16": STEPS * n_k1, "flash_attn": 1,
                    "fused_edit_bf16": STEPS * n_k2, "fused_edit_fold_bf16": STEPS * n_k2}
            want_dims = {"K1 bf16 d=64": STEPS * n_k1, "K1 f32 d=512": 1}
        else:
            want = {**dict.fromkeys(c, 0), "flash_attn": STEPS * n_k1 + 1,
                    "fused_edit": STEPS * n_k2, "fused_edit_fold": STEPS * n_k2}
            want_dims = {"K1 f32 d=64": STEPS * n_k1, "K1 f32 d=512": 1}
        want["flash_merge"] = vae_merges(torch, pipe, 2)
        want["flash_split"] = split_passes(want_dims)
        if c != want or dims != want_dims:
            raise RuntimeError(f"{tag} launch counts {c} {dims}, expected {want} {want_dims}")
        if (img.shape != (2, SD21.image_size, SD21.image_size, 3) or img.dtype != torch.uint8
                or lat.dtype != dtype or not bool(torch.isfinite(lat).all())):
            raise RuntimeError(f"{tag}: images {tuple(img.shape)} {img.dtype}, latents "
                               f"{lat.dtype} or non-finite")
        img_ref, lat_ref, secs_ref = run(None, dtype)
        if bf16:
            r = bf16_drift(torch, tag, lat, lat_ref, lat_ref32)
        else:
            r = {"latent_drift": max_err(torch, lat, lat_ref)}
            if r["latent_drift"] > DRIFT_TOL:
                raise RuntimeError(f"{tag}: fused-edit latents drift {r['latent_drift']} "
                                   f"> {DRIFT_TOL}")
            lat_ref32 = lat_ref
        pix = (img.short() - img_ref.short()).abs().float()
        stats[str(dtype).split(".")[-1]] = {
            "s_per_pair": secs, "s_per_pair_materialized": secs_ref,
            "ms_per_step": secs / STEPS * 1e3, **r, "launches": c, "head_dims": dims}
        counts[dtype] = (c, dims)
        print(f"{tag}: launches {c} {dims} ({n_k1} K1 and {n_k2} K2 sites); latents "
              f"max|Δ| vs kernels=None {r['latent_drift']:.3g}; image max|Δ| "
              f"{pix.max().item():.0f} mean {pix.mean().item():.4f}")
        print(f"{tag}: {secs:.3f} s per image pair with kernels ({secs / STEPS * 1e3:.2f} "
              f"ms per step, VAE and text encoder included), {secs_ref:.3f} s with "
              f"kernels=None")
    return counts, stats


def _edit_runner(torch, pipe, ctrl, x_t):
    """``run(kernels, dtype, scheduler, steps)``: the Replace edit of
    ``ctrl`` from ``x_t`` through ``text2image``, timed from a synchronized
    card: (uint8 images, final latents, seconds)."""
    from p2p_tpu_torch import text2image

    def run(kernels, dtype=torch.float32, scheduler="ddim", steps=STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img, _, _, lat = text2image(pipe, PROMPTS, ctrl, num_steps=steps, latent=x_t,
                                    kernels=kernels, device="cuda", return_latents=True,
                                    dtype=dtype, scheduler=scheduler)
        torch.cuda.synchronize()
        return img, lat, time.perf_counter() - t

    return run


def _check_edit(torch, tag, img, lat, size, dtype) -> None:
    if (img.shape != (2, size, size, 3) or img.dtype != torch.uint8 or lat.dtype != dtype
            or not bool(torch.isfinite(lat).all())):
        raise RuntimeError(f"{tag}: images {tuple(img.shape)} {img.dtype}, latents "
                           f"{lat.dtype} or non-finite")


def multistep_path(torch, K, pipe):
    """The main path's SD-1.4 Replace edit (512², 2 prompts, 50 steps, CFG
    7.5, store off) under the PLMS and the DPM-Solver++ samplers, in f32,
    with ``kernels=KernelConfig()`` and with ``kernels=None``. PLMS makes 51
    U-Net calls (its second timestep repeated), DPM 50: the launch counts
    must be exactly 5 K1 and 22 K2 (each with its fold) a U-Net call plus 1
    K1 for the VAE, and the final latents within ``DRIFT_TOL`` of the
    materialized run's."""
    from p2p_tpu_torch import KernelConfig, attention_replace

    ctrl = attention_replace(PROMPTS, STEPS, 0.8, 0.4, pipe.tokenizer, store=False)
    x_t = torch.randn((1, 64, 64, 4), generator=torch.Generator("cuda").manual_seed(8191),
                      device="cuda")
    run = _edit_runner(torch, pipe, ctrl, x_t)
    counts, stats = {}, {}
    for scheduler, calls in (("plms", STEPS + 1), ("dpm", STEPS)):
        tag = f"sd14 {scheduler}"
        K.reset_launch_counts()
        img, lat, secs = run(KernelConfig(), scheduler=scheduler)
        c = path_counts(K)
        want = {**dict.fromkeys(c, 0), "flash_attn": calls * 5 + 1,
                "fused_edit": calls * 22, "fused_edit_fold": calls * 22,
                "flash_merge": vae_merges(torch, pipe, 2)}
        if c != want:
            raise RuntimeError(f"{tag} launch counts {c}, expected {want}")
        _check_edit(torch, tag, img, lat, 512, torch.float32)
        img_ref, lat_ref, secs_ref = run(None, scheduler=scheduler)
        drift = max_err(torch, lat, lat_ref)
        if drift > DRIFT_TOL:
            raise RuntimeError(f"{tag}: fused-edit latents drift {drift} > {DRIFT_TOL}")
        pix = (img.short() - img_ref.short()).abs().float()
        counts[scheduler] = c
        stats[scheduler] = {"s_per_pair": secs, "s_per_pair_materialized": secs_ref,
                            "ms_per_step": secs / STEPS * 1e3, "unet_calls": calls,
                            "ms_per_unet_call": secs / calls * 1e3,
                            "latent_drift": drift, "launches": c}
        print(f"{tag}: launches {c} ({calls} U-Net calls); latents max|Δ| vs "
              f"kernels=None {drift:.3g}; image max|Δ| {pix.max().item():.0f} mean "
              f"{pix.mean().item():.4f}")
        print(f"{tag}: {secs:.3f} s per image pair with kernels ({secs / STEPS * 1e3:.2f} "
              f"ms per step, {secs / calls * 1e3:.2f} ms per U-Net call, VAE and text "
              f"encoder included), {secs_ref:.3f} s with kernels=None")
    return counts, stats


def ldm_path(torch, K):
    """The LDM-256 Replace edit (``models/config.py:LDM256``: LDMBert, the
    32² latent, head_dim 64, the VQ-f8 decode) at full width and depth from
    random weights of seed 0: 2 prompts, DDIM 50 steps, CFG 5.0, store off,
    in f32 and in bf16 (the decode in f32), each with
    ``kernels=KernelConfig()`` and with ``kernels=None``. Its largest self
    site has 1024 positions, under the flash threshold, so the exact launch
    counts are K2 (with its fold) at every fused-edit site a step and
    nothing else; f32: final latents within ``DRIFT_TOL`` of the
    materialized run; bf16: the drift held as the SD-1.4 bf16 edit's
    (:func:`bf16_drift`)."""
    from p2p_tpu_torch import KernelConfig, attention_replace, random_pipeline
    from p2p_tpu_torch.kernels.dispatch import site_variant
    from p2p_tpu_torch.models.config import LDM256, unet_layout
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    t0 = time.perf_counter()
    tok = HashWordTokenizer(vocab_size=LDM256.text.vocab_size)
    pipe = random_pipeline(LDM256, tok, "cuda", seed=0)
    torch.cuda.synchronize()
    print(f"LDM-256 random weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    ctrl = attention_replace(PROMPTS, STEPS, 0.8, 0.4, tok, store=False)
    metas = unet_layout(LDM256.unet).metas
    variants = [site_variant(KernelConfig(), ctrl, m) for m in metas]
    n_k2 = variants.count("fused-edit")
    n_k1 = sum(1 for v, m in zip(variants, metas) if v == "flash" and m.pixels >= 2048)
    if (n_k2, n_k1) != (27, 0):
        raise RuntimeError(f"ldm256 dispatch: {n_k2} fused-edit and {n_k1} K1 sites, "
                           "expected 27 and 0")
    size = LDM256.latent_size
    x_t = torch.randn((1, size, size, 4), generator=torch.Generator("cuda").manual_seed(8191),
                      device="cuda")
    run = _edit_runner(torch, pipe, ctrl, x_t)
    stats, counts = {}, {}
    lat_ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tag = "ldm256 bf16" if bf16 else "ldm256"
        run(KernelConfig(), dtype, steps=2)          # warm-up: weights, cuDNN
        K.reset_launch_counts()
        img, lat, secs = run(KernelConfig(), dtype)
        c = path_counts(K)
        dims = K.head_dim_launch_counts()
        sfx = "_bf16" if bf16 else ""
        want = {**dict.fromkeys(c, 0), f"fused_edit{sfx}": STEPS * n_k2,
                f"fused_edit_fold{sfx}": STEPS * n_k2}
        if c != want or dims:
            raise RuntimeError(f"{tag} launch counts {c} {dims}, expected {want} and "
                               "no K1, K3 or K4")
        _check_edit(torch, tag, img, lat, LDM256.image_size, dtype)
        img_ref, lat_ref, secs_ref = run(None, dtype)
        if bf16:
            r = bf16_drift(torch, tag, lat, lat_ref, lat_ref32)
        else:
            r = {"latent_drift": max_err(torch, lat, lat_ref)}
            if r["latent_drift"] > DRIFT_TOL:
                raise RuntimeError(f"{tag}: fused-edit latents drift {r['latent_drift']} "
                                   f"> {DRIFT_TOL}")
            lat_ref32 = lat_ref
        pix = (img.short() - img_ref.short()).abs().float()
        stats[str(dtype).split(".")[-1]] = {
            "s_per_pair": secs, "s_per_pair_materialized": secs_ref,
            "ms_per_step": secs / STEPS * 1e3, **r, "launches": c}
        counts[dtype] = c
        print(f"{tag}: launches {c} ({n_k2} K2 sites); latents max|Δ| vs kernels=None "
              f"{r['latent_drift']:.3g}; image max|Δ| {pix.max().item():.0f} mean "
              f"{pix.mean().item():.4f}")
        print(f"{tag}: {secs:.3f} s per image pair with kernels ({secs / STEPS * 1e3:.2f} "
              f"ms per step, VAE and text encoder included), {secs_ref:.3f} s with "
              f"kernels=None")
    return counts, stats


def compare_inversions(art, art16, inv, inv16, tag: str) -> None:
    """Record in ``inv16`` and print the bf16 inversion beside the f32 one:
    times, ms per inner iteration, peak memory, and the bf16-vs-f32 RMS
    distances of x_T and of the embeddings."""
    import numpy as np

    inv16["bf16_vs_f32"] = dist = {f"{name}_rms": float(np.sqrt(np.mean(
        (getattr(art16, name).astype(np.float64) - getattr(art, name)) ** 2)))
        for name in ("x_t", "uncond_embeddings")}
    print(f"{tag} bf16: {inv16['s_total']:.3f} s, "
          f"{inv16['ms_per_inner_iteration']:.2f} ms per inner iteration, peak "
          f"{inv16['max_memory_allocated'] / 2**30:.2f} GiB; f32 {inv['s_total']:.3f} s, "
          f"{inv['ms_per_inner_iteration']:.2f} ms, "
          f"{inv['max_memory_allocated'] / 2**30:.2f} GiB; bf16 vs f32 RMS: x_T "
          f"{dist['x_t_rms']:.4g}, embeddings {dist['uncond_embeddings_rms']:.4g}")


def sd21_inversion_path(torch, K, pipe):
    """The SD-2.1 768-v null-text inversion at the reference defaults (50
    outer steps, 10 inner, early stop 1e-5, CFG 7.5) on a seeded 768²
    image, in f32 and in bf16 (:func:`inversion_path`: K3 and both K4
    passes at d = 64 at the 9 gradient sites, 4 at 96² and 5 at 48², K1 at
    d = 64 at the rest and at d = 512, (1, 1, 9216, 512), for the VAE; the
    norms' window sums in bf16), and the replay of each artifact
    (:func:`replay_path`, LocalBlend at 24): the f32 one in f32, the bf16 one
    in bf16, held against its own f32 materialized replay. Returns the
    numbers of each."""
    art, image, inv = inversion_path(torch, K, pipe, tag="sd21 inversion")
    _, _, replay = replay_path(torch, K, pipe, art, image, tag="sd21 replay")
    art16, _, inv16 = inversion_path(torch, K, pipe, torch.bfloat16,
                                     tag="sd21 inversion bf16")
    compare_inversions(art, art16, inv, inv16, "sd21 inversion")
    _, _, replay16 = replay_path(torch, K, pipe, art16, image, torch.bfloat16,
                                 tag="sd21 replay bf16 of the bf16 artifact",
                                 f32_reference=True)
    return {"f32": inv, "bf16": inv16, "replay": replay, "replay_bf16": replay16}


#: What K1/K3 in f32 at d = 64 run on.
F32_D64_UNITS = ("tensor cores, 3xTF32: tf32 wgmma (m64n64k8 Q K^T with Q's hi and lo "
                 "in registers, m64n64k8 P V with P from registers and a transposed, "
                 "k-permuted V copy) fed by TMA, 64-key tiles split once a call by "
                 "flash_split_kv_tf32_kernel (CUDA cores)")


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
    t_start = time.perf_counter()
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
    sm90_ptxas = check_no_spills(report)

    from p2p_tpu_torch import random_pipeline
    from p2p_tpu_torch.kernels.flash import d40_occupancy
    from p2p_tpu_torch.models.config import SD14
    from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer

    sass, sass_bwd, sass_bwd_tf32, sass_fwd_tf32 = (sm90_sass(build, name)
                                                    for name in SM90_LIBRARIES)
    d40_blocks, d40_warps = d40_occupancy()
    print(f"K1/K3 d = 40 kernel: {d40_warps} warps a block, {d40_blocks} "
          "blocks per SM")
    k1 = k1_phases(torch, K, F)
    k2 = k2_phases(torch, K, F)
    k34 = k34_phases(torch, K, F)
    k1_bf16 = k1_bf16_phases(torch, K, F)
    k2_bf16 = k2_phases(torch, K, F, torch.bfloat16)
    k34_bf16 = k34_bf16_phases(torch, K, F)
    k1_d512_bf16 = k1_d512_bf16_phases(torch, K, F)
    d512_splits = d512_split_sweep(torch, F)
    window_sums = window_sum_phase(torch, K)
    from p2p_tpu_torch.models.config import LDM256, SD21, SD21_BASE

    k1_d64 = k1_d64_phases(torch, K, F, torch.float32)
    k1_d64_bf16 = k1_d64_phases(torch, K, F, torch.bfloat16)
    k34_d64 = k34_d64_phases(torch, K, F, torch.float32)
    k34_d64_bf16 = k34_d64_phases(torch, K, F, torch.bfloat16)
    k2_d64 = k2_phases(torch, K, F, cfgs=(SD21, SD21_BASE, LDM256))
    k2_d64_bf16 = k2_phases(torch, K, F, torch.bfloat16, cfgs=(SD21, SD21_BASE, LDM256))
    t0 = time.perf_counter()
    pipe = random_pipeline(SD14, HashWordTokenizer(), "cuda", seed=0)
    torch.cuda.synchronize()
    print(f"SD-1.4 random weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    counts, counts16, path = main_path(torch, K, pipe)
    ms_counts, multistep = multistep_path(torch, K, pipe)
    art, image, inversion = inversion_path(torch, K, pipe, steps=SD14_INVERSION_STEPS)
    replay_counts, replay_lat, replay = replay_path(torch, K, pipe, art, image)
    replay16_counts, _, replay16 = replay_path(torch, K, pipe, art, image, torch.bfloat16,
                                               replay_lat)
    replay["bf16"] = replay16
    art16, _, inversion16 = inversion_path(torch, K, pipe, torch.bfloat16,
                                           steps=SD14_INVERSION_STEPS)
    inversion["bf16"] = inversion16
    compare_inversions(art, art16, inversion, inversion16, "inversion")
    replay16i_counts, _, replay16i = replay_path(torch, K, pipe, art16, image, torch.bfloat16,
                                                 tag="replay bf16 of the bf16 artifact")
    replay["bf16_of_bf16_artifact"] = replay16i
    del pipe, art, art16
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = random_pipeline(SD21, HashWordTokenizer(), "cuda", seed=0)
    torch.cuda.synchronize()
    print(f"SD-2.1 768-v random weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    sd21_counts, sd21 = sd21_path(torch, K, pipe)
    sd21_inv = sd21_inversion_path(torch, K, pipe)
    sd21["inversion"] = sd21_inv
    dims_inv21, dims_inv21_16 = (sd21_inv[k]["launches_by_head_dim"] for k in ("f32", "bf16"))
    (c21, dims21), (c21_16, dims21_16) = (sd21_counts[torch.float32],
                                          sd21_counts[torch.bfloat16])
    del pipe
    torch.cuda.empty_cache()
    ldm_counts, ldm = ldm_path(torch, K)
    c_ldm, c_ldm16 = ldm_counts[torch.float32], ldm_counts[torch.bfloat16]
    inv_counts = inversion["launches"]
    inv16_counts = inversion16["launches"]
    result = {"kernels": [
        kernel_entry("flash_attn", "p2p_tpu_torch/csrc/flash_attn.cu",
                     "p2p_tpu/models/nn.py:330", counts["flash_attn"], k1,
                     merge_launches={"main_path": counts["flash_merge"],
                                     "inversion": inv_counts["flash_merge"],
                                     "replay": replay_counts["flash_merge"]},
                     multistep_launches={k: c["flash_attn"] for k, c in ms_counts.items()},
                     sd21_d512_launches={"f32": dims21["K1 f32 d=512"],
                                         "bf16": dims21_16["K1 f32 d=512"],
                                         "inversion": dims_inv21["K1 f32 d=512"],
                                         "inversion_bf16": dims_inv21_16["K1 f32 d=512"]},
                     units="tensor cores, 3xTF32, at d = 40 (flash_d40_kernel) "
                           "and d = 512 (flash_d512_kernel)",
                     d40_occupancy={"warps": d40_warps, "blocks_per_sm": d40_blocks},
                     note="launches counts wrapper calls; a d = 512 call that "
                          "splits its keys also launches flash_merge_kernel "
                          "(merge_launches), and its ms includes the merge"),
        kernel_entry("fused_edit", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", counts["fused_edit"], k2,
                     fold_launches={"main_path": counts["fused_edit_fold"],
                                    "replay": replay_counts["fused_edit_fold"],
                                    **{k: c["fused_edit_fold"] for k, c in ms_counts.items()}},
                     multistep_launches={k: c["fused_edit"] for k, c in ms_counts.items()},
                     units="tensor cores, 3xTF32 (edit_attn_kernel), after an f32 "
                           "fold on the CUDA cores (fold_kernel)",
                     note="launches counts wrapper calls; each also launches "
                          "fold_kernel (fold_launches), and its ms includes the "
                          "fold; library_ms is null (no PyTorch call computes "
                          "the edit), sdpa_yardstick_ms times SDPA at the same "
                          "shapes; bound_ms counts the folded work, "
                          "unfolded_flops the work of the earlier unfolded f32 kernel"),
        kernel_entry("flash_attn_residuals", "p2p_tpu_torch/csrc/flash_attn.cu",
                     "p2p_tpu/models/nn.py:343", inv_counts["flash_attn_residuals"],
                     [k34["K3"]],
                     units="tensor cores, 3xTF32 (flash_d40_kernel, K1's kernel "
                           "writing m and l)"),
        kernel_entry("flash_attn_bwd_dq", "p2p_tpu_torch/csrc/flash_attn_bwd.cu",
                     "p2p_tpu/models/nn.py:308", inv_counts["flash_attn_bwd_dq"],
                     [k34["K4_dq"]]),
        kernel_entry("flash_attn_bwd_dkv", "p2p_tpu_torch/csrc/flash_attn_bwd.cu",
                     "p2p_tpu/models/nn.py:308", inv_counts["flash_attn_bwd_dkv"],
                     [k34["K4_dkv"]]),
        kernel_entry("flash_attn_bf16", "p2p_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "p2p_tpu/models/nn.py:330", counts16["flash_attn_bf16"], k1_bf16,
                     units="tensor cores, bf16: wgmma (m64n128k16 Q K^T in 3 k16 steps, "
                           "m64n40k16 P V with P from registers) fed by TMA, Q in "
                           "zero-filled 64-column boxes, K and V in 40-column ones "
                           "(flash_fwd_sm90_kernel<40>)",
                     replay_launches=replay16_counts["flash_attn_bf16"],
                     inversion_bf16_launches=inv16_counts["flash_attn_bf16"],
                     replay_of_bf16_artifact_launches=replay16i_counts["flash_attn_bf16"],
                     note="K1 with bf16 q, k, v and output at d = 40 (launches from "
                          "the bf16 edit; inversion_bf16_launches counts every bf16 "
                          "K1, the d = 512 encode's among them); library_ms is SDPA "
                          "in bf16",
                     sass=sass, ptxas=sm90_ptxas.get("flash_fwd_sm90_kernel<40>")),
        kernel_entry("flash_attn_d512_bf16", "p2p_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "p2p_tpu/models/nn.py:330",
                     inversion16["launches_by_head_dim"]["K1 bf16 d=512"], k1_d512_bf16,
                     units="tensor cores, bf16: wgmma (m64n64k16 Q K^T over each "
                           "warpgroup's 64 keys, m64n256k16 P V over its 256 columns, "
                           "both from shared memory) fed by TMA, and the key split's "
                           "flash_merge_kernel<bf16> (flash_d512_sm90_kernel)",
                     sd21_inversion_bf16_launches=dims_inv21_16["K1 bf16 d=512"],
                     merge_launches={"inversion_bf16": inv16_counts["flash_merge"],
                                     "sd21_inversion_bf16":
                                         sd21_inv["bf16"]["launches"]["flash_merge"]},
                     note="K1 in bf16 at d = 512, the bf16 inversions' VAE encode "
                          "(launches from the SD-1.4 bf16 inversion); ms includes "
                          "the key-split merge (key_splits per row); merge_launches "
                          "counts the inversion's merges of both dtypes (the f32 "
                          "decode's too); library_ms is SDPA in bf16",
                     sass=sass, ptxas=sm90_ptxas.get("flash_d512_sm90_kernel")),
        kernel_entry("flash_attn_residuals_bf16", "p2p_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "p2p_tpu/models/nn.py:343", inv16_counts["flash_attn_residuals_bf16"],
                     [k34_bf16["K3"]],
                     units="tensor cores, bf16: wgmma fed by TMA, Q in zero-filled "
                           "64-column boxes, K and V in 40-column ones "
                           "(flash_fwd_sm90_kernel<40> writing m and l)",
                     note="launches from the bf16 inversion; library_ms is SDPA "
                          "forward in bf16",
                     sass=sass, ptxas=sm90_ptxas.get("flash_fwd_sm90_kernel<40>")),
        *(kernel_entry(f"flash_attn_bwd_{p}_bf16", "p2p_tpu_torch/csrc/flash_bwd_sm90.cu",
                       "p2p_tpu/models/nn.py:308", inv16_counts[f"flash_attn_bwd_{p}_bf16"],
                       [k34_bf16[f"K4_{p}"]],
                       units=f"tensor cores, bf16: wgmma fed by TMA, 40-column rows in "
                             f"zero-filled 64-column boxes (flash_bwd_{p}_sm90_kernel<40>)",
                       note="launches from the bf16 inversion; library_ms is SDPA's "
                            "backward alone in bf16, sdpa_fwd_bwd_ms its forward and "
                            "backward; graph_ms and library_graph_ms the pass and SDPA's "
                            "backward alone replayed as CUDA graphs",
                       sass=sass_bwd, ptxas=sm90_ptxas.get(f"flash_bwd_{p}_sm90_kernel<40>"))
          for p in ("dq", "dkv")),
        kernel_entry("window_sum_bf16", "p2p_tpu_torch/csrc/window_sum.cu",
                     "p2p_tpu/models/nn.py:140", inv16_counts["window_sum_bf16"],
                     window_sums,
                     units="CUDA cores, f32 adds rounded to bf16 (window_sum_bf16_kernel)",
                     note="no pallas_call: the backward of the bf16 norms' broadcasts "
                          "as XLA compiles it (windowed bf16 sums), so the bf16 "
                          "gradient rounds where the JAX program's does; launches from "
                          "the bf16 inversion, per_gradient_launches from one gradient "
                          "on its own; library_ms is torch.sum in bf16",
                     per_gradient_launches=inversion16["window_sum_launches_per_gradient"]),
        kernel_entry("fused_edit_bf16", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", counts16["fused_edit_bf16"],
                     k2_bf16,
                     fold_launches={"main_path": counts16["fused_edit_fold_bf16"],
                                    "replay": replay16_counts["fused_edit_fold_bf16"]},
                     replay_launches=replay16_counts["fused_edit_bf16"],
                     units="tensor cores, bf16 (edit_attn_bf16_kernel, attn_bf16.cuh), "
                           "after the fold in f32 writing bf16 (fold_kernel<bf16>)",
                     note="as fused_edit, with bf16 q, k, v, output and folded "
                          "values; sdpa_yardstick_ms is SDPA in bf16"),
        kernel_entry("flash_attn_d64", "p2p_tpu_torch/csrc/flash_fwd_tf32_sm90.cu",
                     "p2p_tpu/models/nn.py:330", dims21["K1 f32 d=64"], k1_d64,
                     units=F32_D64_UNITS + " (flash_fwd_tf32_sm90_kernel)",
                     split_launches={"sd21": c21["flash_split"],
                                     "sd21_inversion": sd21_inv["f32"]["launches"]["flash_split"]},
                     note="K1 at SD-2.1's head dim 64 (wrapper flash_attention); "
                          "launches from the sd21 f32 edit; each call also launches "
                          "flash_split_kv_tf32_kernel (split_launches, K1's and K3's), "
                          "and its ms includes it; library_ms is SDPA in f32",
                     sass=sass_fwd_tf32, ptxas=sm90_ptxas.get("flash_fwd_tf32_sm90_kernel")),
        kernel_entry("flash_attn_d64_bf16", "p2p_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "p2p_tpu/models/nn.py:330", dims21_16["K1 bf16 d=64"], k1_d64_bf16,
                     units="tensor cores, bf16: wgmma (m64n128k16 Q K^T, m64n64k16 P V "
                           "with P from registers) fed by TMA (flash_fwd_sm90_kernel<64>)",
                     note="launches from the sd21 bf16 edit; library_ms is SDPA in bf16",
                     sass=sass, ptxas=sm90_ptxas.get("flash_fwd_sm90_kernel<64>")),
        kernel_entry("flash_attn_residuals_d64", "p2p_tpu_torch/csrc/flash_fwd_tf32_sm90.cu",
                     "p2p_tpu/models/nn.py:343", dims_inv21["K3 f32 d=64"], k34_d64["K3"],
                     units=F32_D64_UNITS + " (flash_fwd_tf32_sm90_kernel writing m and l)",
                     note="K3 at d = 64, the SD-2.1 inversion's gradient sites (768-v "
                          "and 512-base shapes); launches from the sd21 f32 inversion; "
                          "ms includes the split pass; library_ms is SDPA forward in f32",
                     sass=sass_fwd_tf32, ptxas=sm90_ptxas.get("flash_fwd_tf32_sm90_kernel")),
        kernel_entry("flash_attn_residuals_d64_bf16", "p2p_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "p2p_tpu/models/nn.py:343", dims_inv21_16["K3 bf16 d=64"],
                     k34_d64_bf16["K3"],
                     units="tensor cores, bf16: wgmma fed by TMA (flash_fwd_sm90_kernel<64> "
                           "writing m and l)",
                     note="launches from the sd21 bf16 inversion; library_ms is SDPA "
                          "forward in bf16",
                     sass=sass, ptxas=sm90_ptxas.get("flash_fwd_sm90_kernel<64>")),
        *(kernel_entry(f"flash_attn_bwd_{p}_d64{sfx}", f"p2p_tpu_torch/csrc/{source}.cu",
                       "p2p_tpu/models/nn.py:308", dims[f"K4 {p} {dt} d=64"],
                       rows[f"K4_{p}"],
                       units=(f"tensor cores, bf16: wgmma fed by TMA "
                              f"(flash_bwd_{p}_sm90_kernel)" if sfx else
                              f"tensor cores, 3xTF32: tf32 wgmma fed by TMA, 32-row tiles "
                              f"split in shared memory (flash_bwd_{p}_tf32_sm90_kernel)"),
                       note=f"K4's {p} pass at d = 64, the SD-2.1 inversion's gradient "
                            f"sites (768-v and 512-base shapes); launches from the sd21 "
                            f"{dt} inversion; library_ms is SDPA's backward alone in "
                            f"{dt}, sdpa_fwd_bwd_ms its forward and backward; graph_ms "
                            f"and library_graph_ms the pass and SDPA's backward alone "
                            f"replayed as CUDA graphs",
                       sass=sass_bwd if sfx else sass_bwd_tf32,
                       ptxas=sm90_ptxas.get(f"flash_bwd_{p}_sm90_kernel<64>" if sfx else
                                            f"flash_bwd_{p}_tf32_sm90_kernel"))
          for sfx, dt, dims, rows, source in (
              ("", "f32", dims_inv21, k34_d64, "flash_bwd_tf32_sm90"),
              ("_bf16", "bf16", dims_inv21_16, k34_d64_bf16, "flash_bwd_sm90"))
          for p in ("dkv", "dq")),
        kernel_entry("fused_edit_d64", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", c21["fused_edit"], k2_d64,
                     fold_launches=c21["fused_edit_fold"],
                     ldm256_launches=c_ldm["fused_edit"],
                     ldm256_fold_launches=c_ldm["fused_edit_fold"],
                     units="tensor cores, 3xTF32 (edit_attn_kernel<64>) after fold_kernel",
                     note="K2 at D = 64, the SD-2.1 geometries (sd21 and sd21base) and "
                          "LDM-256's; launches from the sd21 f32 edit, ldm256_launches "
                          "from the LDM-256 f32 edit; as fused_edit otherwise"),
        kernel_entry("fused_edit_d64_bf16", "p2p_tpu_torch/csrc/fused_edit.cu",
                     "p2p_tpu/kernels/fused_edit.py:210", c21_16["fused_edit_bf16"],
                     k2_d64_bf16, fold_launches=c21_16["fused_edit_fold_bf16"],
                     ldm256_launches=c_ldm16["fused_edit_bf16"],
                     ldm256_fold_launches=c_ldm16["fused_edit_fold_bf16"],
                     units="tensor cores, bf16 (edit_attn_bf16_kernel<64>) after "
                           "fold_kernel<bf16>",
                     note="as fused_edit_d64, in bf16; launches from the sd21 bf16 edit, "
                          "ldm256_launches from the LDM-256 bf16 edit"),
    ], "main_path": path, "multistep": multistep, "inversion": inversion,
        "replay": replay, "sd21": sd21, "ldm256": ldm,
        "d512_key_splits": d512_splits,
        "replay_launches": replay_counts, "replay_bf16_launches": replay16_counts,
        "replay_bf16_of_bf16_artifact_launches": replay16i_counts,
        "card": card}
    # K3 + K4 per inner iteration from the kernel phase's times, against the
    # measured inner iteration.
    n_grad = inv_counts["flash_attn_residuals"] // inversion["inner_iterations"]
    k34_ms = n_grad * sum(k34[k]["ms"] for k in ("K3", "K4_dq", "K4_dkv"))
    inversion["k3_k4_ms_per_inner_iteration"] = k34_ms
    print(f"inversion: K3 + K4 at {n_grad} sites take {k34_ms:.3f} ms of the "
          f"{inversion['ms_per_inner_iteration']:.2f} ms inner iteration "
          f"({100 * k34_ms / inversion['ms_per_inner_iteration']:.1f} %)")
    k34_16_ms = n_grad * sum(k34_bf16[k]["ms"] for k in ("K3", "K4_dq", "K4_dkv"))
    inversion16["k3_k4_ms_per_inner_iteration"] = k34_16_ms
    print(f"inversion bf16: K3 + K4 bf16 at {n_grad} sites take {k34_16_ms:.3f} ms of "
          f"the {inversion16['ms_per_inner_iteration']:.2f} ms inner iteration "
          f"({100 * k34_16_ms / inversion16['ms_per_inner_iteration']:.1f} %)")
    # The same at SD-2.1 768-v: 4 gradient sites at 96² and 5 at 48².
    from p2p_tpu_torch.models.config import unet_layout

    metas = unet_layout(SD21.unet).metas
    first_cross = min(m.layer_idx for m in metas if m.is_cross)
    sites = [m.pixels for m in metas if not m.is_cross and m.pixels >= 2048
             and m.layer_idx > first_cross]
    for dt, rows, inv in (("f32", k34_d64, sd21_inv["f32"]), ("bf16", k34_d64_bf16,
                                                             sd21_inv["bf16"])):
        ms = sum(r["ms"] for k in ("K3", "K4_dq", "K4_dkv") for r in rows[k]
                 for px in sites if r["shape"][2] == px)
        inv["k3_k4_ms_per_inner_iteration"] = ms
        print(f"sd21 inversion {dt}: K3 + K4 at {len(sites)} sites take {ms:.3f} ms of "
              f"the {inv['ms_per_inner_iteration']:.2f} ms inner iteration "
              f"({100 * ms / inv['ms_per_inner_iteration']:.1f} %)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
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
