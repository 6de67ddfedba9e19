"""The SD-2.1 null-text inversion and its replay against the JAX package, on
the CPU.

Kernel level, at SD-2.1's head dim 64: K3 + K4 through
``FlashAttentionFunction`` (K3's and K4's plain passes on the CPU) against
``jax.grad`` of the Pallas flash kernel run by the Pallas interpreter
(``force_tpu_interpret_mode``) at (1, 2, 1024, 64) with blocks of 512, f32
within 1e-4 of each gradient's largest magnitude (``tests/
test_torch_flash_grad.py``'s bar at d = 40) and bf16 within 1e-2
(``tests/test_torch_bf16_inversion.py``'s); K3 in f32 against the
interpreted ``flash_attention_residuals`` within 1e-5.

Whole path, on TINY-v-48: ``tests/test_torch_sd21.py``'s TINY-v (heads of
16, the gelu text tower, v-prediction) with a 48² latent (192² image), so
its top U-Net level and VAE mid block hold 2304 ≥ 2048 pixels and both
sides take their flash paths (the port K3 and K4's plain passes under the
gradient). Same weights on both sides, made with numpy in the JAX
package's init scheme (``tests/test_torch_bf16_inversion.py:_weights``).
The null-text loss gradient at the first outer step, ``invert`` (2 outer
steps, 2 inner) and the replay of the JAX artifact under Replace +
LocalBlend + Reweight, LocalBlend at 12, a quarter of the latent side (24
at 768-v's 96²). f32 bars as ``tests/test_torch_inversion.py``'s: the
gradient within 1e-4 of its largest magnitude, x_T within 1e-4,
embeddings within 1e-3, equal inner counts, the replay's latents within
1e-3. bf16 as ``tests/test_torch_bf16_inversion.py:_hold``: within √2 of
the JAX package's bf16-vs-f32 distance of the JAX bf16 result, and at
least half that distance from the port's f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.engine import inversion as jinv  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import config as j_config  # noqa: E402
from p2p_tpu.models import init_text_encoder, init_unet  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402
from p2p_tpu.models import vae as jvae  # noqa: E402
from p2p_tpu.models.unet import apply_unet as j_apply_unet  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils import progress as jprogress  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.engine import inversion as pinv  # noqa: E402
from p2p_tpu_torch.engine.sampler import Pipeline, encode_prompts, text2image  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.models import config as p_config  # noqa: E402
from p2p_tpu_torch.models.unet import apply_unet  # noqa: E402
from p2p_tpu_torch.ops import schedulers as psched  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402

from tests.test_torch_bf16_inversion import _hold, _weights, few_threads  # noqa: E402,F401
from tests.test_torch_inversion import image, tiny48  # noqa: E402,F401
from tests.test_torch_sd21 import tiny_v  # noqa: E402

TB, JB = torch.bfloat16, jnp.bfloat16
D = 64
PROMPT = "a cat riding a bike"
PROMPTS = [PROMPT, "a dog riding a bike"]
STEPS = 2
INNER = 2
BLEND_RES = 12         # a quarter of the 48² latent's side
EQ = {"words": ("dog",), "values": (2.0,)}

J_CFG, P_CFG = tiny48(tiny_v(j_config.TINY)), tiny48(tiny_v(p_config.TINY))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkvg(seed, shape, dtype):
    """q, k, v and an output cotangent g from numpy: ``(jax q, k, v, torch
    q, k, v, g)``, q, k and v rounded to ``dtype`` on both sides."""
    rng = np.random.RandomState(seed)
    j = [jnp.asarray(rng.randn(*shape), dtype) for _ in range(3)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))) for a in j]
    if dtype == JB:
        t = [a.to(TB) for a in t]
    return (*j, *t, rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (JB, 1e-2)], ids=["f32", "bf16"])
def test_k3_k4_d64_plain_passes_match_jax_grad_pallas_interpret(dtype, tol):
    """The loss ``Σ o·g``: dq, dk and dv through the port's autograd
    Function against ``jax.grad`` of the interpreted Pallas kernel, whose
    backward is the library's dkv and dq kernels (blocks of 512)."""
    jq, jk, jv, q, k, v, g = _qkvg(21, (1, 2, 1024, D), dtype)
    scale = D ** -0.5

    def loss(q, k, v):
        return jnp.sum(jnn.flash_attention_tpu(q, k, v, scale, 512).astype(jnp.float32) * g)

    with force_tpu_interpret_mode():
        want = [np.asarray(a.astype(jnp.float32)) for a in
                jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = K.FlashAttentionFunction.apply(tq, tk, tv, scale)
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), (tq, tk, tv))
    assert all(a.dtype == q.dtype for a in got)
    errs = [_rel(a.float(), w) for a, w in zip(got, want)]
    print(f"K4 d=64 {np.dtype(dtype).name} (dq, dk, dv) of the largest magnitude: {errs}")
    assert max(errs) <= tol, errs


def test_k3_d64_f32_plain_matches_pallas_interpret():
    """K3 in f32 at d = 64: ``(out, l, m)``, 2x2 blocks of 256."""
    jq, jk, jv, q, k, v, _ = _qkvg(22, (1, 2, 512, D), jnp.float32)
    scale = D ** -0.5
    with force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jnn.flash_attention_residuals(jq, jk, jv, scale, 256)]
    got = K.flash_attention_residuals_plain(q, k, v, scale, chunk=192)
    for name, a, w in zip(("out", "l", "m"), got, want):
        assert a.shape == w.shape, name
        assert np.abs(a.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


# ------------------------------------------------------------ whole path


@pytest.fixture(scope="module")
def pipes():
    """The JAX TINY-v-48 pipeline and the port's, holding the same weights."""
    rng = np.random.default_rng(21)
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
    return jpipe, ppipe


def _image_f(image):
    return (image.astype(np.float32) / 127.5 - 1.0)[None]


def test_tiny_v48_takes_the_flash_gradient_at_head_dim_16():
    """TINY-v-48 is a v-prediction config whose top level runs K3/K4."""
    assert P_CFG.scheduler.prediction_type == "v_prediction"
    big = [(ch // heads, res) for _, cross, res, heads, _, ch in
           p_config.unet_attn_specs(P_CFG.unet) if not cross and res * res >= 2048]
    assert big and all(d == 16 and res == 48 for d, res in big)


def test_null_text_loss_grad_matches_jax(pipes, image):
    """The gradient with respect to the f32 uncond embedding at the first
    outer step, from the port's f32 DDIM inversion's latents on both sides
    (rounded to bf16 for the bf16 runs); f32 within 1e-4 of the largest
    magnitude, bf16 held by ``_hold``."""
    jpipe, ppipe = pipes
    js = jsched.schedule_from_config(STEPS, J_CFG.scheduler, kind="ddim")
    ps = psched.schedule_from_config(STEPS, P_CFG.scheduler, kind="ddim")
    with torch.no_grad():
        _, x_t, lats = pinv.ddim_invert(ppipe, ps, torch.from_numpy(_image_f(image)),
                                        encode_prompts(ppipe, [PROMPT]))
    t = int(js.timesteps[0])
    gs = J_CFG.guidance_scale
    x_t, target = x_t.numpy(), lats[STEPS - 1].numpy()

    @jax.jit
    def grad_fn(params, x_t, cond, u0, target):
        eps_cond, _ = j_apply_unet(params, J_CFG.unet, x_t, t, cond)

        def loss_fn(u):
            eps_u, _ = j_apply_unet(params, J_CFG.unet, x_t, t, u.astype(cond.dtype))
            eps = eps_u + jnp.float32(gs) * (eps_cond - eps_u)
            eps = jsched.to_epsilon(js, eps, t, x_t)
            prev = jsched.ddim_step(js, eps, t, x_t.astype(jnp.float32))
            return jnp.mean(jnp.square(prev - target.astype(jnp.float32)))

        return jax.grad(loss_fn)(u0.astype(jnp.float32))

    want, got = {}, {}
    for jdt, pdt in ((jnp.float32, torch.float32), (JB, TB)):
        want[pdt] = np.asarray(grad_fn(
            jpipe.unet_params, jnp.asarray(x_t, jdt),
            jsampler.encode_prompts(jpipe, [PROMPT], dtype=jdt),
            jsampler.encode_prompts(jpipe, [""], dtype=jdt), jnp.asarray(target, jdt)))
        x_p = torch.from_numpy(x_t).to(pdt)
        with torch.no_grad():
            cond_p = encode_prompts(ppipe, [PROMPT], pdt)
            u = encode_prompts(ppipe, [""], pdt).float()
            eps_cond, _ = apply_unet(ppipe.weights(pdt)[0], P_CFG.unet, x_p, t, cond_p)
        u.requires_grad_(True)
        loss = pinv.null_text_loss(ppipe, ps, x_p, t, u, eps_cond,
                                   torch.from_numpy(target).to(pdt), gs)
        (grad,) = torch.autograd.grad(loss, u)
        got[pdt] = grad.numpy()
    f32 = torch.float32
    assert np.abs(got[f32] - want[f32]).max() <= 1e-4 * np.abs(want[f32]).max()
    _hold("null-text loss gradient", want[TB], got[TB], got[f32])


@pytest.fixture(scope="module")
def inversions(pipes, image):
    """``(side, dtype) → (artifact, inner counts)`` at the default early
    stop, cached; the JAX counts come from its ``invert.inner_steps``
    events."""
    jpipe, ppipe = pipes
    cache = {}

    def run(side, dtype):
        if (side, dtype) in cache:
            return cache[side, dtype]
        if side == "jax":
            counts = []

            def sink(tag, value, phase):
                if tag == "invert.inner_steps":
                    counts.append(int(value))

            jprogress.set_obs_sink(sink)
            try:
                art = jinv.invert(jpipe, image, PROMPT, num_steps=STEPS,
                                  num_inner_steps=INNER,
                                  dtype=JB if dtype == TB else jnp.float32, metrics=True)
                jax.effects_barrier()
            finally:
                jprogress.set_obs_sink(None)
        else:
            art = pinv.invert(ppipe, image, PROMPT, num_steps=STEPS, num_inner_steps=INNER,
                              dtype=dtype, device="cpu")
            counts = art.inner_steps
        cache[side, dtype] = (art, counts)
        return cache[side, dtype]

    return run


def test_invert_f32_matches_jax(inversions):
    want, want_counts = inversions("jax", torch.float32)
    got, counts = inversions("port", torch.float32)
    assert counts == want_counts and len(counts) == STEPS
    assert got.x_t.shape == want.x_t.shape == (1, 48, 48, 4)
    assert got.uncond_embeddings.shape == want.uncond_embeddings.shape == (STEPS, 1, 16, 32)
    assert np.abs(got.x_t - want.x_t).max() <= 1e-4
    assert np.abs(got.uncond_embeddings - want.uncond_embeddings).max() <= 1e-3
    d = np.abs(got.image_rec.astype(np.int16) - want.image_rec.astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())


def test_invert_bf16_matches_jax_bf16(inversions):
    j16, jc = inversions("jax", TB)
    p16, pc = inversions("port", TB)
    p32, _ = inversions("port", torch.float32)
    assert pc == jc and len(pc) == STEPS
    np.testing.assert_array_equal(p16.x_t, p16.x_t.astype(jnp.bfloat16).astype(np.float32))
    _hold("x_T", j16.x_t.astype(np.float32), p16.x_t, p32.x_t)
    _hold("embeddings", j16.uncond_embeddings, p16.uncond_embeddings, p32.uncond_embeddings)


def _controllers():
    common = dict(is_replace_controller=True, cross_replace_steps=0.8,
                  self_replace_steps=0.4, num_steps=STEPS,
                  blend_words=(("cat",), ("dog",)), equalizer_params=EQ,
                  blend_resolution=BLEND_RES)
    return (jfactory.make_controller(PROMPTS, tokenizer=JTok(model_max_length=16), **common),
            pfactory.make_controller(PROMPTS, tokenizer=PTok(model_max_length=16), **common))


@pytest.mark.parametrize("dtype", [torch.float32, TB], ids=["f32", "bf16"])
def test_replay_of_jax_artifact_matches_jax(pipes, inversions, dtype):
    """The JAX artifact of ``dtype`` replayed under Replace + LocalBlend +
    Reweight by both packages in ``dtype``, and by the port in f32 too; the
    final latents."""
    jpipe, ppipe = pipes
    art, _ = inversions("jax", dtype)
    x_t = np.asarray(art.x_t.astype(jnp.float32))
    uncond = art.uncond_embeddings
    jdt = JB if dtype == TB else jnp.float32
    jc, pc = _controllers()
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None, 2, jdt)
    _, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, J_CFG, j_config.unet_layout(J_CFG.unet),
        jsched.schedule_from_config(STEPS, J_CFG.scheduler, kind="ddim"), "ddim",
        jsampler.encode_prompts(jpipe, PROMPTS, dtype=jdt),
        jsampler.encode_prompts(jpipe, ["", ""], dtype=jdt), lat, jc,
        jnp.float32(J_CFG.guidance_scale), jnp.asarray(uncond), False)
    want = np.asarray(latents.astype(jnp.float32))
    got = {}
    for pdt in {torch.float32, dtype}:
        _, _, _, lat_p = text2image(ppipe, PROMPTS, pc, num_steps=STEPS,
                                    latent=torch.from_numpy(x_t),
                                    uncond_embeddings=torch.from_numpy(uncond),
                                    dtype=pdt, device="cpu", return_latents=True)
        assert lat_p.dtype == pdt and lat_p.shape == (2, 48, 48, 4)
        got[pdt] = lat_p.float().numpy()
    if dtype == torch.float32:
        assert np.abs(got[dtype] - want).max() <= 1e-3
    else:
        _hold("replay latents", want, got[TB], got[torch.float32])


def test_blend_resolution_is_a_quarter_of_the_latent_side():
    """LocalBlend's maps exist at a quarter of the latent side (12 here,
    16 at SD-1.4 and 512-base, 24 at 768-v) and not at SD-1.4's 16 on a
    96² latent."""
    for cfg, res in ((P_CFG, BLEND_RES), (p_config.SD14, 16), (p_config.SD21_BASE, 16),
                     (p_config.SD21, 24)):
        layout = p_config.unet_layout(cfg.unet)
        assert res == cfg.latent_size // 4 and layout.blend_metas(res), cfg.name
    assert not p_config.unet_layout(p_config.SD21.unet).blend_metas(16)
