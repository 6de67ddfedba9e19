"""The port's null-text inversion against the JAX package's, on TINY-48.

TINY-48 is TINY with a 48² latent (192² image): its top U-Net level and
its VAE mid block hold 2304 ≥ 2048 pixels, so both sides take their flash
paths — on the port, K3's and K4's plain versions through
``FlashAttentionFunction`` under the gradient. Same weights on both sides
(``from_jax_params``), inputs made with numpy from a seed.

Bars, each with its reason:
- ``ddim_next_step`` ≤ 1e-6: the same f32 formula on both sides.
- VAE encode ≤ 1e-4: f32 convolutions summed in different orders.
- gradient of the null-text loss ≤ 1e-4 of its largest magnitude: f32
  forward and backward through the U-Net in different orders.
- ``invert``: x_T ≤ 1e-4 (2 DDIM inversion steps of U-Net rounding); uncond
  embeddings ≤ 1e-3, because Adam's first step is ``g / (|g| + 1e-8)``
  and amplifies f32 gradient noise where ``|g|`` is small; the VAE
  reconstruction within the golden-image tolerance (max ≤ 3, mean ≤ 0.5);
  the inner-iteration counts equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.engine import inversion as jinv  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.models import TINY as J_TINY, init_text_encoder, init_unet  # noqa: E402
from p2p_tpu.models import vae as jvae  # noqa: E402
from p2p_tpu.models.unet import apply_unet as j_apply_unet  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils import progress as jprogress  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch.engine import inversion as pinv  # noqa: E402
from p2p_tpu_torch.engine.sampler import Pipeline, encode_prompts  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.models import vae as pvae  # noqa: E402
from p2p_tpu_torch.models.config import TINY  # noqa: E402
from p2p_tpu_torch.models.unet import apply_unet  # noqa: E402
from p2p_tpu_torch.ops import schedulers as psched  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402

PROMPT = "a cat riding a bike"
STEPS = 2
INNER = 3


def tiny48(cfg):
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, sample_size=48), image_size=192)


J_CFG, P_CFG = tiny48(J_TINY), tiny48(TINY)


@pytest.fixture(scope="module")
def pipes():
    """The JAX TINY-48 pipeline and the port's, holding the same weights."""
    jpipe = jsampler.Pipeline(
        config=J_CFG,
        unet_params=init_unet(jax.random.PRNGKey(0), J_CFG.unet),
        text_params=init_text_encoder(jax.random.PRNGKey(1), J_CFG.text),
        vae_params=jvae.init_vae(jax.random.PRNGKey(2), J_CFG.vae),
        tokenizer=JTok(model_max_length=16))
    tree = jax.tree.map(np.asarray, (jpipe.unet_params, jpipe.text_params,
                                     jpipe.vae_params))
    ppipe = Pipeline(
        config=P_CFG,
        unet=ck.from_jax_params(tree[0], ck.unet_entries(P_CFG.unet)),
        text_encoder=ck.from_jax_params(tree[1], ck.text_encoder_entries(P_CFG.text)),
        vae=ck.from_jax_params(tree[2], ck.vae_entries(P_CFG.vae)),
        tokenizer=PTok(model_max_length=16))
    return jpipe, ppipe


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).integers(0, 256, (192, 192, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_invert(pipes, image):
    """``eps → (artifact, inner-step counts)`` of the JAX ``invert``,
    cached; the counts come from its ``invert.inner_steps`` events."""
    jpipe, _ = pipes
    cache = {}

    def run(eps):
        if eps not in cache:
            counts = []

            def sink(tag, value, phase):
                if tag == "invert.inner_steps":
                    counts.append(int(value))

            jprogress.set_obs_sink(sink)
            try:
                art = jinv.invert(jpipe, image, PROMPT, num_steps=STEPS,
                                  num_inner_steps=INNER,
                                  early_stop_epsilon=eps, metrics=True)
                jax.effects_barrier()
            finally:
                jprogress.set_obs_sink(None)
            cache[eps] = (art, counts)
        return cache[eps]

    return run


def _image_f(image):
    return (image.astype(np.float32) / 127.5 - 1.0)[None]


def test_ddim_next_step_matches_jax():
    rng = np.random.RandomState(0)
    eps, sample = (rng.randn(1, 8, 8, 4).astype(np.float32) for _ in range(2))
    js = jsched.schedule_from_config(5, J_CFG.scheduler, kind="ddim")
    ps = psched.schedule_from_config(5, P_CFG.scheduler, kind="ddim")
    for t in ps.timesteps.tolist():
        want = jsched.ddim_next_step(js, jnp.asarray(eps), jnp.int32(t),
                                     jnp.asarray(sample))
        got = psched.ddim_next_step(ps, torch.from_numpy(eps), t,
                                    torch.from_numpy(sample))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6, t


def test_vae_encode_matches_jax(pipes, image):
    jpipe, ppipe = pipes
    x = _image_f(image)
    j_mean, j_logvar = jvae.encode_moments(jpipe.vae_params, J_CFG.vae, jnp.asarray(x))
    p_mean, p_logvar = pvae.encode_moments(ppipe.vae, P_CFG.vae, torch.from_numpy(x))
    assert p_mean.shape == (1, 48, 48, 4)
    assert np.abs(p_mean.numpy() - np.asarray(j_mean)).max() <= 1e-4
    assert np.abs(p_logvar.numpy() - np.asarray(j_logvar)).max() <= 1e-4
    want = jvae.encode(jpipe.vae_params, J_CFG.vae, jnp.asarray(x))
    got = pvae.encode(ppipe.vae, P_CFG.vae, torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def _count_nodes(fn, name):
    seen, stack, n = set(), [fn], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += type(f).__name__ == name
        stack.extend(nxt for nxt, _ in f.next_functions)
    return n


def test_null_text_loss_grad_matches_jax(pipes, image):
    """The gradient with respect to the uncond embedding at the first outer
    step, both sides from the JAX inversion's latents."""
    jpipe, ppipe = pipes
    js = jsched.schedule_from_config(STEPS, J_CFG.scheduler, kind="ddim")
    cond = jsampler.encode_prompts(jpipe, [PROMPT])
    u0 = jsampler.encode_prompts(jpipe, [""])
    # metrics=True: the program the invert tests compile.
    _, x_t, lats = jinv._ddim_invert_jit(jpipe.unet_params, jpipe.vae_params,
                                         J_CFG, js, jnp.asarray(_image_f(image)),
                                         cond, metrics=True)
    t = int(js.timesteps[0])
    gs = J_CFG.guidance_scale
    target = lats[STEPS - 1]

    @jax.jit
    def grad_fn(params, x_t, cond, u0, target):
        eps_cond, _ = j_apply_unet(params, J_CFG.unet, x_t, t, cond)

        def loss_fn(u):
            eps_u, _ = j_apply_unet(params, J_CFG.unet, x_t, t, u)
            eps = jsched.to_epsilon(js, eps_u + gs * (eps_cond - eps_u), t, x_t)
            prev = jsched.ddim_step(js, eps, t, x_t)
            return jnp.mean(jnp.square(prev - target))

        return jax.grad(loss_fn)(u0)

    want = np.asarray(grad_fn(jpipe.unet_params, x_t, cond, u0, target))

    ps = psched.schedule_from_config(STEPS, P_CFG.scheduler, kind="ddim")
    x_t_p = torch.from_numpy(np.array(x_t))
    with torch.no_grad():
        cond_p = encode_prompts(ppipe, [PROMPT])
        u = encode_prompts(ppipe, [""])
        eps_cond_p, _ = apply_unet(ppipe.unet, P_CFG.unet, x_t_p, t, cond_p)
    u.requires_grad_(True)
    loss = pinv.null_text_loss(ppipe, ps, x_t_p, t, u, eps_cond_p,
                               torch.from_numpy(np.array(target)), gs)
    # The 2304-pixel self sites after the first cross site see the
    # embedding: K3 + K4 (plain on the CPU) through the autograd Function.
    assert _count_nodes(loss.grad_fn, "FlashAttentionFunctionBackward") == 2
    (got,) = torch.autograd.grad(loss, u)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("eps", [-1.0, 1e9, 1e-5],
                         ids=["no-early-stop", "one-step", "default"])
def test_invert_matches_jax(pipes, image, jax_invert, eps):
    _, ppipe = pipes
    want, want_counts = jax_invert(eps)
    got = pinv.invert(ppipe, image, PROMPT, num_steps=STEPS,
                      num_inner_steps=INNER, early_stop_epsilon=eps, device="cpu")
    assert got.inner_steps == want_counts
    assert len(want_counts) == STEPS
    if eps == -1.0:
        assert want_counts == [INNER] * STEPS
    if eps == 1e9:
        assert want_counts == [1] * STEPS
    assert got.x_t.shape == want.x_t.shape == (1, 48, 48, 4)
    assert np.abs(got.x_t - want.x_t).max() <= 1e-4
    assert got.uncond_embeddings.shape == want.uncond_embeddings.shape
    assert np.abs(got.uncond_embeddings - want.uncond_embeddings).max() <= 1e-3
    np.testing.assert_array_equal(got.image_gt, want.image_gt)
    d = np.abs(got.image_rec.astype(np.int16) - want.image_rec.astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())


def test_artifact_loads_across_packages(jax_invert, tmp_path):
    art, _ = jax_invert(1e9)
    jpath = str(tmp_path / "jax.npz")
    art.save(jpath)
    loaded = pinv.InversionArtifact.load(jpath)
    np.testing.assert_array_equal(loaded.x_t, art.x_t)
    np.testing.assert_array_equal(loaded.uncond_embeddings, art.uncond_embeddings)
    np.testing.assert_array_equal(loaded.image_rec, art.image_rec)
    assert (loaded.prompt, loaded.num_steps) == (art.prompt, art.num_steps)

    ppath = str(tmp_path / "port.npz")
    loaded.inner_steps = [1, 1]
    loaded.save(ppath)
    back = jinv.InversionArtifact.load(ppath)
    np.testing.assert_array_equal(back.x_t, art.x_t)
    np.testing.assert_array_equal(back.uncond_embeddings, art.uncond_embeddings)
    np.testing.assert_array_equal(back.image_gt, art.image_gt)
    assert (back.prompt, back.num_steps) == (art.prompt, art.num_steps)
    assert sorted(np.load(ppath).files) == sorted(np.load(jpath).files)
