"""The SD-2.1 slice of the port against the JAX package, on the CPU.

- K1 at d = 64 (SD-2.1's head dim), f32 and bf16, and K3 in bf16: the plain
  versions against the JAX package's Pallas flash kernel under the
  interpreter at (1, 2, 1024, 64) in blocks of 256 (the online softmax over
  four key blocks), f32 within 2e-5 (as ``tests/test_torch_kernels.py``
  holds d = 40), bf16 outputs within 1e-2 of the largest magnitude and K3's
  f32 ``l``, ``m`` within 1e-5 relative (as
  ``tests/test_torch_bf16_inversion.py`` holds d = 40); the d = 64 kernels'
  arithmetic (``kernels.tf32.flash_d40``, ``kernels.bf16.flash``) against the
  plain versions.
- The static dispatch at every site of ``SD21`` (768-v) and ``SD21_BASE``
  (512) under ``attention_replace``: the port's site variant equals the JAX
  package's, the JAX package finds a fused-edit query block at every site
  both send to K2, and the port takes K1 exactly where the JAX package's
  ``flash_block`` finds a block, in f32 and bf16.
- The v-prediction conversion, and ``text2image`` with Replace on a
  TINY-shaped SD-2.1 (TINY with head_dim 16, the gelu text tower and
  v-prediction, built the same way on both sides), materialized and with
  the kernels: f32 latents within 1e-3 and uint8 images within 3 (mean 0.5)
  of the JAX package's (``tests/test_torch_pipeline.py``'s bars); bf16
  within √2 of the JAX package's own bf16-vs-f32 distance and at least half
  of it from the port's f32 (``tests/test_torch_bf16_pipeline.py``'s bar).
- The inversion's K4 guard: every preset's head dims have K4 kernels, so
  the CLI takes ``invert``/``replay`` on SD-2.1, and a head dim without
  them is refused by name (``tests/test_torch_sd21_inversion.py`` holds
  the SD-2.1 inversion itself).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402
from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.kernels import site_variant as j_site_variant  # noqa: E402
from p2p_tpu.models import config as j_config  # noqa: E402
from p2p_tpu.models import init_text_encoder, init_unet  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402
from p2p_tpu.models import vae as jvae  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch import cli  # noqa: E402
from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.engine.sampler import Pipeline, text2image  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig, site_variant  # noqa: E402
from p2p_tpu_torch.kernels import bf16 as kbf16  # noqa: E402
from p2p_tpu_torch.kernels import tf32  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.models import config as p_config  # noqa: E402
from p2p_tpu_torch.models import nn as pnn  # noqa: E402
from p2p_tpu_torch.ops import schedulers as psched  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402

from tests.test_torch_bf16_inversion import _weights, few_threads  # noqa: E402,F401

JB, TB = jnp.bfloat16, torch.bfloat16
D = 64
SCALE = D ** -0.5
KERNEL_TOL = 1e-2      # bf16 outputs, of the largest magnitude
STATS_TOL = 1e-5       # K3's f32 m and l, relative
BF16_BAR = float(np.sqrt(2.0))
PROMPTS = ["a cat riding a bike", "a dog riding a bike"]
STEPS = 3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkv(seed, dtype):
    rng = np.random.RandomState(seed)
    j = [jnp.asarray(rng.randn(1, 2, 1024, D), dtype) for _ in range(3)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))) for a in j]
    return j, [a.to(TB) for a in t] if dtype == JB else t


def test_k1_d64_f32_plain_and_emulation_match_pallas():
    (jq, jk, jv), (q, k, v) = _qkv(0, jnp.float32)
    with force_tpu_interpret_mode():
        want = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, SCALE, 256))
    plain = K.flash_attention_plain(q, k, v, SCALE)
    assert np.abs(plain.numpy() - want).max() <= 2e-5
    got = tf32.flash_d40(q, k, v, SCALE)    # flash_fwd_tf32_sm90_kernel's steps
    ref = K.flash_attention_residuals_plain(q, k, v, SCALE)
    for name, g, r in zip(("out", "l", "m"), got, ref):
        assert _rel(g, r) <= 2e-6, (name, _rel(g, r))
    assert np.abs(got[0].numpy() - want).max() <= 2e-5


def test_k1_k3_d64_bf16_plain_and_emulation_match_pallas():
    (jq, jk, jv), (q, k, v) = _qkv(1, JB)
    with force_tpu_interpret_mode():
        want = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, SCALE, 256)
                          .astype(jnp.float32))
        want3 = [np.asarray(a.astype(jnp.float32)) for a in
                 jnn.flash_attention_residuals(jq, jk, jv, SCALE, 256)]
    plain = K.flash_attention_plain(q, k, v, SCALE)
    assert plain.dtype == TB
    assert _rel(plain.float(), want) <= KERNEL_TOL, _rel(plain.float(), want)
    emulated = kbf16.flash(q, k, v, SCALE).to(TB).float()
    assert _rel(emulated, want) <= KERNEL_TOL
    assert _rel(emulated, plain.float()) <= KERNEL_TOL
    out, l, m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    assert out.dtype == TB and l.dtype == m.dtype == torch.float32
    assert _rel(out.float(), want3[0]) <= KERNEL_TOL
    assert _rel(l, want3[1]) <= STATS_TOL and _rel(m, want3[2]) <= STATS_TOL


@pytest.mark.parametrize("preset", ["SD21", "SD21_BASE"])
def test_site_variants_and_k1_choice_match_jax(preset):
    jcfg, pcfg = getattr(j_config, preset), getattr(p_config, preset)
    L = jcfg.text.max_length
    jc = jfactory.attention_replace(PROMPTS, 50, 0.8, 0.4, JTok(model_max_length=L),
                                    max_len=L, store=False)
    pc = pfactory.attention_replace(PROMPTS, 50, 0.8, 0.4, PTok(model_max_length=L),
                                    max_len=L, store=False)
    jmetas = j_config.unet_layout(jcfg.unet).metas
    got = [site_variant(KernelConfig(), pc, m) for m in p_config.unet_layout(pcfg.unet).metas]
    want = [j_site_variant(JKernelConfig(), jc, m, "off") for m in jmetas]
    assert got == want
    k1_sites = 0
    for variant, m in zip(got, jmetas):
        d = m.channels // m.heads
        assert d == D
        for itemsize in (4, 2):
            if variant == "fused-edit":
                assert jnn.edit_block(m.pixels, m.key_len, d, itemsize) != 0, m
            if variant == "flash":
                # The port's fused_attention takes K1 for an unmasked self site
                # with S >= FLASH_MIN_SEQ; the JAX package where flash_block
                # finds a block (else XLA's attention, never the einsum).
                port_k1 = not m.is_cross and m.pixels >= pnn.FLASH_MIN_SEQ
                jax_k1 = (not m.is_cross and m.pixels >= 2048
                          and jnn.flash_block(m.pixels, d, itemsize) != 0)
                assert port_k1 == jax_k1, (m, itemsize)
        k1_sites += variant == "flash" and m.pixels >= pnn.FLASH_MIN_SEQ
    # The VAE's mid attention: one head of 512 over the latent's pixels.
    s = jcfg.unet.sample_size ** 2
    assert s >= pnn.FLASH_MIN_SEQ and jnn.flash_block(s, 512, 4) != 0
    counts = {"fused-edit": got.count("fused-edit"), "k1": k1_sites}
    assert counts == ({"fused-edit": 17, "k1": 10} if preset == "SD21"
                      else {"fused-edit": 22, "k1": 5})


def test_v_prediction_to_epsilon_matches_jax():
    js = jsched.schedule_from_config(50, j_config.SD21.scheduler, kind="ddim")
    ps = psched.schedule_from_config(50, p_config.SD21.scheduler, kind="ddim")
    assert ps.prediction_type == "v_prediction"
    rng = np.random.RandomState(5)
    out, x = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    for t in (981, 501, 1):
        want = np.asarray(jsched.to_epsilon(js, jnp.asarray(out), t, jnp.asarray(x, JB)))
        got = psched.to_epsilon(ps, torch.from_numpy(out), t,
                                torch.from_numpy(x).to(TB))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def tiny_v(cfg):
    """TINY as an SD-2.1: heads of 16, the gelu text tower, v-prediction."""
    return dataclasses.replace(
        cfg, name="tiny-v", unet=dataclasses.replace(cfg.unet, head_dim=16),
        text=dataclasses.replace(cfg.text, activation="gelu"),
        scheduler=dataclasses.replace(cfg.scheduler, prediction_type="v_prediction"))


J_CFG, P_CFG = tiny_v(j_config.TINY), tiny_v(p_config.TINY)


@pytest.fixture(scope="module")
def runs():
    """``{(side, dtype, kernels): (uint8 images, f32 latents)}`` of the
    Replace edit, 3 DDIM steps, one x_T, on TINY-v."""
    rng = np.random.default_rng(11)
    tree = (_weights(init_unet, J_CFG.unet, rng),
            _weights(init_text_encoder, J_CFG.text, rng),
            _weights(jvae.init_vae, J_CFG.vae, rng))
    jpipe = jsampler.Pipeline(config=J_CFG, unet_params=jax.tree.map(jnp.asarray, tree[0]),
                              text_params=jax.tree.map(jnp.asarray, tree[1]),
                              vae_params=jax.tree.map(jnp.asarray, tree[2]),
                              tokenizer=JTok(model_max_length=16))
    ppipe = Pipeline(
        config=P_CFG,
        unet=ck.from_jax_params(tree[0], ck.unet_entries(P_CFG.unet)),
        text_encoder=ck.from_jax_params(tree[1], ck.text_encoder_entries(P_CFG.text)),
        vae=ck.from_jax_params(tree[2], ck.vae_entries(P_CFG.vae)),
        tokenizer=PTok(model_max_length=16))
    x_t = np.random.RandomState(4).randn(1, 16, 16, 4).astype(np.float32)
    jc = jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, JTok(model_max_length=16),
                                    max_len=16, store=False)
    pc = pfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, PTok(model_max_length=16),
                                    max_len=16, store=False)
    out = {}
    for fused in (False, True):
        for jdt, pdt in ((jnp.float32, torch.float32), (JB, TB)):
            ctx_c = jsampler.encode_prompts(jpipe, PROMPTS, dtype=jdt)
            ctx_u = jsampler.encode_prompts(jpipe, [""] * len(PROMPTS), dtype=jdt)
            _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None,
                                          len(PROMPTS), jdt)
            image, latents, _ = jsampler._text2image_jit(
                jpipe.unet_params, jpipe.vae_params, J_CFG, j_config.unet_layout(J_CFG.unet),
                jsched.schedule_from_config(STEPS, J_CFG.scheduler, kind="ddim"), "ddim",
                ctx_c, ctx_u, lat, jc, jnp.float32(J_CFG.guidance_scale), None, False,
                kernels=JKernelConfig(interpret=True) if fused else None)
            out["jax", pdt, fused] = (np.asarray(image),
                                      np.asarray(latents.astype(jnp.float32)))
            img, _, _, plat = text2image(
                ppipe, PROMPTS, pc, num_steps=STEPS, latent=torch.from_numpy(x_t),
                kernels=KernelConfig() if fused else None, device="cpu",
                return_latents=True, dtype=pdt)
            assert img.dtype == torch.uint8 and img.shape == (2, 64, 64, 3)
            assert plat.dtype == pdt
            out["port", pdt, fused] = (img.numpy(), plat.float().numpy())
    return out


def _dist(a, b):
    lat = a[1].astype(np.float64) - b[1]
    img = np.abs(a[0].astype(np.int16) - b[0].astype(np.int16))
    return (np.abs(lat).max(), np.sqrt(np.mean(lat ** 2)), img.max(), img.mean())


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "kernels"])
def test_text2image_f32_matches_jax(runs, fused):
    (p_img, p_lat), (j_img, j_lat) = runs["port", torch.float32, fused], runs[
        "jax", torch.float32, fused]
    assert np.abs(p_lat - j_lat).max() <= 1e-3
    d = np.abs(p_img.astype(np.int16) - j_img.astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "kernels"])
def test_text2image_bf16_matches_jax_bf16(runs, fused):
    j16, j32 = runs["jax", TB, fused], runs["jax", torch.float32, fused]
    p16, p32 = runs["port", TB, fused], runs["port", torch.float32, fused]
    bar, got, own = _dist(j16, j32), _dist(p16, j16), _dist(p16, p32)
    msg = (f"(latents max, rms, image max, mean): port-vs-JAX bf16 {got}; JAX "
           f"bf16-vs-f32 {bar}; port bf16-vs-f32 {own}")
    print(msg)
    assert all(b > 0 for b in bar), msg
    assert all(g <= BF16_BAR * b for g, b in zip(got, bar)), msg
    assert own[0] >= 0.5 * bar[0] and own[1] >= 0.5 * bar[1], msg


K4_CASES = [("tiny", None), ("sd14", None), ("sd21", None), ("sd21base", None),
            ("invert", "cli"), ("replay", "cli"), ("head_dim_80", 80)]


@pytest.mark.parametrize("case,arg", K4_CASES, ids=[c for c, _ in K4_CASES])
def test_cli_inversion_on_sd21_names_k4(case, arg, tmp_path):
    """K4 has kernels at every preset's head dims, so ``require_k4`` passes
    for each preset and the CLI's ``invert`` and ``replay`` take the SD-2.1
    presets (``_reject_inversion`` on their parsed arguments: ``cli.main``
    would build SD-2.1's weights on the CPU); a config whose self site of
    2048 pixels or more has a head dim without kernels is still refused,
    naming it."""
    from p2p_tpu_torch.engine.inversion import require_k4

    if arg is None:
        require_k4(p_config.PRESET_CONFIGS[case], case)
    elif arg == "cli":
        argv = ([case, "--preset", "sd21", "--device", "cpu"]
                + (["--image", "x.png", "--prompt", "a cat"] if case == "invert"
                   else ["--artifact", str(tmp_path / "a.npz"), "--blend-resolution", "24"]))
        args = cli.build_parser().parse_args(argv)
        assert (args.cmd, args.preset) == (case, "sd21")
        assert cli._reject_inversion(args) is None
    else:
        cfg = dataclasses.replace(p_config.SD14, unet=dataclasses.replace(
            p_config.SD14.unet, head_dim=arg))
        with pytest.raises(NotImplementedError, match=f"K4.*head dim {arg}"):
            require_k4(cfg, "invert")
