"""The port's sampler end to end against the JAX package's, on TINY.

Two prompts, 3 DDIM steps, one given x_T, an ``attention_replace`` edit with
and without the attention store; the materialized path on both sides
(``kernels=None``). The fused-edit leg is ``test_torch_pipeline_fused.py``.
Also: the port's static site dispatch agrees with the JAX package's on every
site of the SD-1.4 and TINY layouts.

Bars: final latents max|Δ| ≤ 1e-3 (f32 on both sides; 3 steps of U-Net
rounding in different summation orders, amplified by CFG 7.5), uint8 images
max|Δ| ≤ 3 and mean ≤ 0.5 (the golden-image tolerance of the JAX suite).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402
from p2p_tpu.kernels import site_variant as j_site_variant  # noqa: E402
from p2p_tpu.models import SD14 as J_SD14, TINY as J_TINY  # noqa: E402
from p2p_tpu.models import init_text_encoder, init_unet, vae as jvae  # noqa: E402
from p2p_tpu.models.config import unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.engine.sampler import Pipeline, text2image  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig, site_variant  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.models.config import SD14, TINY, unet_layout  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402

PROMPTS = ["a cat riding a bike", "a dog riding a bike"]
STEPS = 3
SEED = 4


def make_pipes():
    """The JAX TINY pipeline and the port's, holding the same weights."""
    jpipe = jsampler.Pipeline(
        config=J_TINY,
        unet_params=init_unet(jax.random.PRNGKey(0), J_TINY.unet),
        text_params=init_text_encoder(jax.random.PRNGKey(1), J_TINY.text),
        vae_params=jvae.init_vae(jax.random.PRNGKey(2), J_TINY.vae),
        tokenizer=JTok(model_max_length=16))
    tree = jax.tree.map(np.asarray, (jpipe.unet_params, jpipe.text_params,
                                     jpipe.vae_params))
    ppipe = Pipeline(
        config=TINY,
        unet=ck.from_jax_params(tree[0], ck.unet_entries(TINY.unet)),
        text_encoder=ck.from_jax_params(tree[1], ck.text_encoder_entries(TINY.text)),
        vae=ck.from_jax_params(tree[2], ck.vae_entries(TINY.vae)),
        tokenizer=PTok(model_max_length=16))
    return jpipe, ppipe


def controllers(store):
    kw = dict(max_len=16, store=store)
    return (jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4,
                                       JTok(model_max_length=16), **kw),
            pfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4,
                                       PTok(model_max_length=16), **kw))


def jax_run(jpipe, controller, x_t, kernels):
    """The JAX ungated text2image program, returning its final latents too
    (the public entry returns x_T)."""
    cfg = jpipe.config
    ctx_c = jsampler.encode_prompts(jpipe, PROMPTS)
    ctx_u = jsampler.encode_prompts(jpipe, [""] * len(PROMPTS))
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None,
                                  len(PROMPTS))
    image, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, cfg, j_unet_layout(cfg.unet),
        jsched.schedule_from_config(STEPS, cfg.scheduler, kind="ddim"), "ddim",
        ctx_c, ctx_u, lat, controller, jnp.float32(cfg.guidance_scale), None,
        False, kernels=kernels)
    return np.asarray(image), np.asarray(latents)


def compare(store, port_kernels, jax_kernels):
    jpipe, ppipe = make_pipes()
    x_t = np.random.RandomState(SEED).randn(1, 16, 16, 4).astype(np.float32)
    jc, pc = controllers(store)
    j_img, j_lat = jax_run(jpipe, jc, x_t, jax_kernels)
    p_img, p_xt, store_state, p_lat = text2image(
        ppipe, PROMPTS, pc, num_steps=STEPS, latent=torch.from_numpy(x_t),
        kernels=port_kernels, device="cpu", return_store=True,
        return_latents=True)
    assert p_img.dtype == torch.uint8 and p_img.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(p_xt.numpy(), x_t)
    assert len(store_state) == (unet_layout(TINY.unet).num_store_slots
                                if store else 0)
    assert np.abs(p_lat.numpy() - j_lat).max() <= 1e-3
    d = np.abs(p_img.numpy().astype(np.int16) - j_img.astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())


@pytest.mark.parametrize("store", [True, False])
def test_text2image_matches_jax_materialized(store):
    compare(store, None, None)


@pytest.mark.parametrize("cfg_pair", [(J_SD14, SD14), (J_TINY, TINY)],
                         ids=["sd14", "tiny"])
@pytest.mark.parametrize("store", [True, False])
def test_site_variant_matches_jax(cfg_pair, store):
    jcfg, pcfg = cfg_pair
    prompts = ["a cat on a mat", "a dog on a mat"]
    L = jcfg.text.max_length
    jc = jfactory.attention_replace(prompts, 50, 0.8, 0.4, JTok(model_max_length=L),
                                    max_len=L, store=store)
    pc = pfactory.attention_replace(prompts, 50, 0.8, 0.4, PTok(model_max_length=L),
                                    max_len=L, store=store)
    got = [site_variant(KernelConfig(), pc, m)
           for m in unet_layout(pcfg.unet).metas]
    want = [j_site_variant(JKernelConfig(), jc, m, "off")
            for m in j_unet_layout(jcfg.unet).metas]
    assert got == want
    if jcfg is J_SD14:
        # The static dispatch at SD-1.4 (fused-edit / flash / materialized).
        counts = {v: got.count(v) for v in set(got)}
        assert counts == ({"fused-edit": 5, "flash": 5, "materialized": 22}
                          if store else {"fused-edit": 22, "flash": 10})
