"""``text2image(dtype=torch.bfloat16)`` against the JAX package's bf16
program, on TINY.

The Replace edit of ``tests/test_torch_pipeline.py`` (2 prompts, 3 DDIM
steps, one x_T) materialized and with the kernels (the port's
``KernelConfig()``, whose wrappers run their bf16 plain versions on the
CPU, against the JAX ``KernelConfig(interpret=True)``), and the replay of an
f32 null-text artifact (per-step f32 uncond embeddings, numpy-seeded, cast
to bf16 at each step on both sides) under Replace + LocalBlend + Reweight.

Bar. bf16 rounds every primitive. The port rounds where the JAX program
rounds (``tests/test_torch_bf16_modules.py`` holds each primitive to one
ulp), but a sum taken in another order still rounds the other way at about
one element in 10^4, and through 3 steps of CFG 7.5 such differences grow
until the two bf16 runs stand as far apart as bf16 stands from f32: over
these inputs the port-vs-JAX bf16 RMS distance of the latents is 1.01-1.05
times the JAX bf16-vs-f32 one (the same holds between the port's own fused
and materialized bf16 runs on the card, PERF.md). Two bf16 runs, each that
far from f32, are at most √2 times that far from each other when their
roundings are independent. So the port's bf16 latents and uint8 images are
held within √2 times the JAX package's own bf16-vs-f32 distance on the same
inputs (max|Δ| and RMS of the latents, max and mean |Δ| of the images),
measured in the same test; and, so that a port that stayed in f32 would
fail, the port's bf16 run stands at least half that distance from its own
f32 run. The f32 runs of the same test stay within the f32 bar of
``tests/test_torch_pipeline.py`` (latents ≤ 1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402
from p2p_tpu.models.config import unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402

from p2p_tpu_torch.engine.sampler import text2image  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig  # noqa: E402

from tests.test_torch_pipeline import PROMPTS, SEED, STEPS, controllers, make_pipes  # noqa: E402
from tests.test_torch_replay import _controllers as replay_controllers  # noqa: E402

F32_LATENT_TOL = 1e-3
# Two bf16 runs with independent roundings, each at bf16's distance from f32.
BF16_BAR = float(np.sqrt(2.0))


def jax_run(jpipe, controller, x_t, kernels, dtype, uncond=None):
    """The JAX ungated text2image program in ``dtype``: (uint8 images, final
    latents as f32)."""
    cfg = jpipe.config
    ctx_c = jsampler.encode_prompts(jpipe, PROMPTS, dtype=dtype)
    ctx_u = jsampler.encode_prompts(jpipe, [""] * len(PROMPTS), dtype=dtype)
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None,
                                  len(PROMPTS), dtype)
    image, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, cfg, j_unet_layout(cfg.unet),
        jsched.schedule_from_config(STEPS, cfg.scheduler, kind="ddim"), "ddim",
        ctx_c, ctx_u, lat, controller, jnp.float32(cfg.guidance_scale),
        None if uncond is None else jnp.asarray(uncond), False, kernels=kernels)
    return np.asarray(image), np.asarray(latents.astype(jnp.float32))


def port_run(ppipe, controller, x_t, kernels, dtype, uncond=None):
    img, _, _, lat = text2image(
        ppipe, PROMPTS, controller, num_steps=STEPS, latent=torch.from_numpy(x_t),
        kernels=kernels, device="cpu", return_latents=True, dtype=dtype,
        uncond_embeddings=None if uncond is None else torch.from_numpy(uncond))
    assert img.dtype == torch.uint8 and img.shape == (2, 64, 64, 3)
    assert lat.dtype == dtype
    return img.numpy(), lat.float().numpy()


def _dist(a, b):
    """(latents max|Δ|, latents RMS, image max|Δ|, image mean|Δ|) of two
    runs ``(images, latents)``."""
    lat = a[1].astype(np.float64) - b[1]
    img = np.abs(a[0].astype(np.int16) - b[0].astype(np.int16))
    return (np.abs(lat).max(), np.sqrt(np.mean(lat ** 2)), img.max(), img.mean())


def compare(jc, pc, x_t, jk, pk, uncond=None):
    jpipe, ppipe = make_pipes()
    j32 = jax_run(jpipe, jc, x_t, jk, jnp.float32, uncond)
    j16 = jax_run(jpipe, jc, x_t, jk, jnp.bfloat16, uncond)
    p16 = port_run(ppipe, pc, x_t, pk, torch.bfloat16, uncond)
    p32 = port_run(ppipe, pc, x_t, pk, torch.float32, uncond)
    bar, got, own = _dist(j16, j32), _dist(p16, j16), _dist(p16, p32)
    msg = (f"(latents max, rms, image max, mean): port-vs-JAX bf16 {got}; JAX "
           f"bf16-vs-f32 {bar}; port bf16-vs-f32 {own}")
    print(msg)                                # the distances, with -s
    assert all(b > 0 for b in bar), msg       # bf16 really ran on the JAX side
    assert all(g <= BF16_BAR * b for g, b in zip(got, bar)), msg
    assert own[0] >= 0.5 * bar[0] and own[1] >= 0.5 * bar[1], msg
    assert np.abs(p32[1] - j32[1]).max() <= F32_LATENT_TOL


@pytest.mark.parametrize("kernels", ["none", "fused"])
def test_text2image_bf16_matches_jax_bf16(kernels):
    x_t = np.random.RandomState(SEED).randn(1, 16, 16, 4).astype(np.float32)
    jc, pc = controllers(store=False)
    jk, pk = ((JKernelConfig(interpret=True), KernelConfig()) if kernels == "fused"
              else (None, None))
    compare(jc, pc, x_t, jk, pk)


def test_replay_of_f32_artifact_in_bf16_matches_jax_bf16():
    """The f32 artifact's embeddings, cast to bf16 at each step on both
    sides, under Replace + LocalBlend (its mask cast to the latents' bf16)
    + Reweight, with the kernels."""
    rng = np.random.RandomState(7)
    x_t = rng.randn(1, 16, 16, 4).astype(np.float32)
    uncond = rng.randn(STEPS, 1, 16, 32).astype(np.float32)
    jc, pc = replay_controllers()
    compare(jc, pc, x_t, JKernelConfig(interpret=True), KernelConfig(), uncond)


def test_text2image_refuses_other_dtypes():
    _, ppipe = make_pipes()
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        text2image(ppipe, PROMPTS, None, num_steps=STEPS, device="cpu",
                   dtype=torch.float16)
