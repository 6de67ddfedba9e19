"""``invert(dtype=torch.bfloat16)`` and the bf16 kernels it runs, against the
JAX package's bf16 program and its Pallas kernels.

Kernel level: the bf16 plain versions of K3 (flash forward with residuals),
K4 (both backward passes) and K1 at d = 512 against the Pallas TPU kernels
run by the Pallas interpreter (``force_tpu_interpret_mode``), as
``tests/test_torch_flash_grad.py`` runs them in f32. bf16 outputs are held
within 1e-2 of each one's largest magnitude (a few bf16 ulps, 2^-8
relative each, where a rounding falls the other way); K3's f32 ``m`` and
``l`` within 1e-5 relative.

Whole path, on TINY-48 (TINY with a 48² latent, so both sides' VAE mid
block and top U-Net level take their flash paths; on the CPU the JAX side
takes ``jax.nn.dot_product_attention`` there, the port its plain versions):
the bf16 VAE encode, the bf16 null-text loss gradient, ``invert`` in bf16
(no early stop, and a stop after one inner step) and the bf16 replay of its
artifact. Bar, as ``tests/test_torch_bf16_pipeline.py``'s: two bf16 runs
that round anywhere differently part by bf16's own distance from f32, so
the port's bf16 is held within √2 times the JAX package's bf16-vs-f32
distance on the same inputs, measured in the same test, and stands at least
half that distance from its own f32 run, so that a port left in f32 fails.
The f32 run is the port's: ``tests/test_torch_inversion.py`` holds it to
the JAX package's f32 on TINY-48 (x_T within 1e-4, embeddings within 1e-3,
the gradient within 1e-4 of its largest magnitude), a hundredth of the bf16
distances here or less, and the JAX f32 programs would double the JAX
side's compiles, which are nearly all of this file's time.

Also: a JAX bf16 artifact (x_T saved as ml_dtypes bfloat16, read by numpy
as 2-byte void items) loads with its values exact; ``invert`` refuses
float16; and the f32 inversion is bitwise what the f32 code before the
bf16 path gave (the plain kernels and the CFG step of that code, copied
here, swapped in).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.engine import inversion as jinv  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402
from p2p_tpu.models import vae as jvae  # noqa: E402
from p2p_tpu.models.config import unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.models.unet import apply_unet as j_apply_unet  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils import progress as jprogress  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.engine import inversion as pinv  # noqa: E402
from p2p_tpu_torch.engine.sampler import encode_prompts, text2image  # noqa: E402
from p2p_tpu_torch.kernels import flash as pflash  # noqa: E402
from p2p_tpu_torch.kernels import flash_bwd as pflash_bwd  # noqa: E402
from p2p_tpu_torch.models import vae as pvae  # noqa: E402
from p2p_tpu_torch.models.unet import apply_unet  # noqa: E402
from p2p_tpu_torch.ops import schedulers as psched  # noqa: E402

from p2p_tpu_torch.engine.sampler import Pipeline  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402
from p2p_tpu.models import init_text_encoder, init_unet  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from tests.test_torch_inversion import J_CFG, P_CFG, PROMPT, STEPS, image  # noqa: E402,F401

TB, JB = torch.bfloat16, jnp.bfloat16
INNER = 2
KERNEL_TOL = 1e-2      # bf16 outputs, of the largest magnitude
STATS_TOL = 1e-5       # K3's f32 m and l, relative
BF16_BAR = float(np.sqrt(2.0))


def _weights(init, cfg, rng):
    """A parameter tree shaped as ``init`` makes it, filled from ``rng`` by
    the JAX package's init scheme (kernels uniform in ±1/√fan-in, biases 0,
    norm scales 1, token and position embeddings normal at 0.02 and 0.01):
    the same kind of weights without the JAX init's many small compiles."""
    shapes = jax.eval_shape(lambda key: init(key, cfg), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            x = rng.uniform(-bound, bound, leaf.shape)
        elif name in ("token_embed", "pos_embed"):
            x = rng.standard_normal(leaf.shape) * (0.02 if name == "token_embed" else 0.01)
        else:
            x = np.full(leaf.shape, 1.0 if name == "scale" else 0.0)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two PyTorch threads for this module: the JAX side's compiles dominate
    it, and the suite runs it beside other processes that fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    """The JAX TINY-48 pipeline and the port's, holding the same weights."""
    rng = np.random.default_rng(3)
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


def _bf16(*arrays):
    """numpy f32 arrays rounded to bf16: ``(jax arrays, torch tensors)``."""
    j = [jnp.asarray(a, JB) for a in arrays]
    return j, [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(TB) for a in j]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_residuals_bf16_plain_matches_pallas_interpret():
    """K3 in bf16 at (1, 2, 512, 40), 2x2 blocks of 256."""
    rng = np.random.RandomState(11)
    (jq, jk, jv), (q, k, v) = _bf16(*(rng.randn(1, 2, 512, 40).astype(np.float32)
                                      for _ in range(3)))
    scale = 40 ** -0.5
    with force_tpu_interpret_mode():
        want = [np.asarray(a.astype(jnp.float32)) for a in
                jnn.flash_attention_residuals(jq, jk, jv, scale, 256)]
    out, l, m = K.flash_attention_residuals_plain(q, k, v, scale, chunk=192)
    assert out.dtype == TB and l.dtype == m.dtype == torch.float32
    errs = [_rel(out.float(), want[0]), _rel(l, want[1]), _rel(m, want[2])]
    print(f"K3 bf16 (out, l, m) of the largest magnitude: {errs}")
    assert errs[0] <= KERNEL_TOL and max(errs[1:]) <= STATS_TOL, errs


def _bwd_scale_first(q, k, v, do, l, m, di, scale):
    """K4's plain passes with ``ds`` rounded to bf16 *before* the scale (the
    f32 kernels' placement), the scale applied to the f32 sums: the
    placement the library does not take, for the record."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
                  - (m + torch.log(l))[..., None])
    ds = (p * (torch.einsum("bhqd,bhkd->bhqk", do, v) - di[..., None])).to(TB).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(TB).float(), do)
    return dq.to(TB), dk.to(TB), dv.to(TB)


def test_bwd_bf16_plain_passes_match_jax_grad_pallas_interpret():
    """K3 + K4 in bf16 through ``FlashAttentionFunction`` against
    ``jax.grad`` of the Pallas kernel at (1, 2, 1024, 40) with blocks of 512
    (forward and backward 2x2 blocks); the loss ``Σ o·g`` with a random
    ``g``, so the output gradient is ``g`` rounded to bf16 on both sides.
    The variant that rounds ``ds`` before the scale is measured beside it."""
    rng = np.random.RandomState(12)
    (jq, jk, jv), (q, k, v) = _bf16(*(rng.randn(1, 2, 1024, 40).astype(np.float32)
                                      for _ in range(3)))
    g = rng.randn(1, 2, 1024, 40).astype(np.float32)
    scale = 40 ** -0.5

    def loss(q, k, v):
        return jnp.sum(jnn.flash_attention_tpu(q, k, v, scale, 512).astype(jnp.float32) * g)

    with force_tpu_interpret_mode():
        want = [np.asarray(a.astype(jnp.float32)) for a in
                jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = K.FlashAttentionFunction.apply(tq, tk, tv, scale)
    assert out.dtype == TB
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), (tq, tk, tv))
    assert all(t.dtype == TB for t in got)
    errs = [_rel(a.float(), w) for a, w in zip(got, want)]
    o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
    do = torch.from_numpy(g).to(TB)
    di = (o.float() * do.float()).sum(-1)
    other = [_rel(a.float(), w) for a, w in
             zip(_bwd_scale_first(q, k, v, do, l, m, di, scale), want)]
    print(f"K4 bf16 (dq, dk, dv) of the largest magnitude: ds rounded after the "
          f"scale {errs}; before the scale {other}")
    assert max(errs) <= KERNEL_TOL, errs


def test_flash_bf16_d512_plain_matches_pallas_interpret():
    """K1 in bf16 at the VAE's head geometry reduced as
    ``tests/test_flash_pallas.py`` reduces it: (1, 1, 512, 512), 2x2 blocks."""
    rng = np.random.RandomState(13)
    (jq, jk, jv), (q, k, v) = _bf16(*(rng.randn(1, 1, 512, 512).astype(np.float32)
                                      for _ in range(3)))
    scale = 512 ** -0.5
    with force_tpu_interpret_mode():
        want = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, scale, 256).astype(jnp.float32))
    got = K.flash_attention_plain(q, k, v, scale)
    assert got.dtype == TB
    err = _rel(got.float(), want)
    print(f"K1 bf16 d=512 of the largest magnitude: {err}")
    assert err <= KERNEL_TOL, err


# ------------------------------------------------------------ whole path


def _image_f(image):
    return (image.astype(np.float32) / 127.5 - 1.0)[None]


def _dists(a, b):
    """(max|Δ|, RMS) of two f32 arrays."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d).max(), np.sqrt(np.mean(d ** 2))


def _hold(what, j16, p16, p32):
    """The bar: the port's bf16 within √2 x JAX's bf16-vs-f32 distance (the
    f32 run the port's) of JAX's bf16, and at least half that distance from
    the port's f32."""
    bar, got, own = _dists(j16, p32), _dists(p16, j16), _dists(p16, p32)
    msg = (f"{what} (max, rms): port-vs-JAX bf16 {got}; JAX bf16-vs-f32 {bar}; "
           f"port bf16-vs-f32 {own}")
    print(msg)
    assert all(b > 0 for b in bar), msg
    assert all(g <= BF16_BAR * b for g, b in zip(got, bar)), msg
    floor = [0.5 * b for b in bar]
    assert all(o >= f for o, f in zip(own, floor)), (msg, floor)


def _jax_ddim_invert(jpipe, image, dtype):
    """The JAX inversion's first program, as ``invert`` compiles it:
    ``(latent0, x_T, latents)`` in ``dtype``."""
    js = jsched.schedule_from_config(STEPS, J_CFG.scheduler, kind="ddim")
    return jinv._ddim_invert_jit(
        jpipe.unet_params, jpipe.vae_params, J_CFG, js, jnp.asarray(_image_f(image), dtype),
        jsampler.encode_prompts(jpipe, [PROMPT], dtype=dtype),
        progress=False, sp=None, metrics=True)


def test_vae_encode_bf16_matches_jax_bf16(pipes, image):
    """The encode as the JAX inversion runs it, inside its first program."""
    jpipe, ppipe = pipes
    x = _image_f(image)
    j16 = np.asarray(_jax_ddim_invert(jpipe, image, JB)[0].astype(jnp.float32))
    p = {}
    for dt in (torch.float32, TB):
        lat = pvae.encode(ppipe.vae_encoder_weights(dt), P_CFG.vae,
                          torch.from_numpy(x).to(dt))
        assert lat.dtype == dt and lat.shape == (1, 48, 48, 4)
        p[dt] = lat.float().numpy()
    assert all(t.dtype == torch.float32 for t in ppipe.vae.values())
    _hold("VAE encode", j16, p[TB], p[torch.float32])


def test_null_text_loss_grad_bf16_matches_jax_bf16(pipes, image):
    """The gradient with respect to the f32 uncond embedding at the first
    outer step, from the same latents on both sides (the port's f32 DDIM
    inversion's, rounded to bf16 for the bf16 runs).

    Held as every bf16 result of this file is: within √2 times JAX's
    bf16-vs-f32 distance of JAX's bf16 gradient, and at least half that
    distance from the port's f32 one, so that a port left in f32 fails.
    Most of a bf16 gradient's distance from f32 comes from the norms'
    backward, whose sums over the pixels the JAX program accumulates in
    bf16 (``kernels.reduce``; ``tests/test_torch_bf16_grad_taps.py``);
    summed in f32 instead, the port's stood a tenth as far. The gradient is
    also the cotangent of the embedding's cast to bf16, so it holds bf16
    values."""
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

    j16 = np.asarray(grad_fn(jpipe.unet_params, jnp.asarray(x_t, JB),
                             jsampler.encode_prompts(jpipe, [PROMPT], dtype=JB),
                             jsampler.encode_prompts(jpipe, [""], dtype=JB),
                             jnp.asarray(target, JB)))
    p = {}
    for pdt in (torch.float32, TB):
        x_p = torch.from_numpy(x_t).to(pdt)
        with torch.no_grad():
            cond_p = encode_prompts(ppipe, [PROMPT], pdt)
            u = encode_prompts(ppipe, [""], pdt).float()
            eps_cond, _ = apply_unet(ppipe.weights(pdt)[0], P_CFG.unet, x_p, t, cond_p)
        u.requires_grad_(True)
        loss = pinv.null_text_loss(ppipe, ps, x_p, t, u, eps_cond,
                                   torch.from_numpy(target).to(pdt), gs)
        assert loss.dtype == torch.float32
        (grad,) = torch.autograd.grad(loss, u)
        assert grad.dtype == torch.float32
        p[pdt] = grad.numpy()
    np.testing.assert_array_equal(p[TB], p[TB].astype(jnp.bfloat16).astype(np.float32))
    _hold("null-text loss gradient", j16, p[TB], p[torch.float32])


@pytest.fixture(scope="module")
def inversions(pipes, image):
    """``(side, dtype, eps) → (artifact, inner counts)`` of the port's
    ``invert`` in ``dtype`` or the JAX package's in bf16, cached; the JAX
    counts come from its ``invert.inner_steps`` events."""
    jpipe, ppipe = pipes
    cache = {}

    def run(side, dtype, eps):
        key = (side, dtype, eps)
        if key in cache:
            return cache[key]
        if side == "jax":
            counts = []

            def sink(tag, value, phase):
                if tag == "invert.inner_steps":
                    counts.append(int(value))

            jprogress.set_obs_sink(sink)
            try:
                art = jinv.invert(jpipe, image, PROMPT, num_steps=STEPS,
                                  num_inner_steps=INNER, early_stop_epsilon=eps,
                                  dtype=JB, metrics=True)
                jax.effects_barrier()
            finally:
                jprogress.set_obs_sink(None)
        else:
            art = pinv.invert(ppipe, image, PROMPT, num_steps=STEPS,
                              num_inner_steps=INNER, early_stop_epsilon=eps,
                              dtype=dtype, device="cpu")
            counts = art.inner_steps
        cache[key] = (art, counts)
        return cache[key]

    return run


@pytest.mark.parametrize("eps", [-1.0, 1e9], ids=["no-early-stop", "one-step"])
def test_invert_bf16_matches_jax_bf16(inversions, eps):
    j16, jc = inversions("jax", TB, eps)
    p16, pc = inversions("port", TB, eps)
    p32, _ = inversions("port", torch.float32, eps)
    assert pc == jc == ([INNER] * STEPS if eps < 0 else [1] * STEPS)
    assert p16.x_t.dtype == np.float32 and p16.x_t.shape == (1, 48, 48, 4)
    np.testing.assert_array_equal(p16.x_t, p16.x_t.astype(jnp.bfloat16).astype(np.float32))
    assert p16.uncond_embeddings.dtype == np.float32
    np.testing.assert_array_equal(p16.image_gt, j16.image_gt)
    _hold("x_T", j16.x_t.astype(np.float32), p16.x_t, p32.x_t)
    _hold("embeddings", j16.uncond_embeddings, p16.uncond_embeddings,
          p32.uncond_embeddings)
    # The reconstruction decodes the bf16 latent in f32 on both sides.
    _hold("reconstruction", j16.image_rec, p16.image_rec, p32.image_rec)


def test_replay_of_bf16_artifact_in_bf16_matches_jax_bf16(pipes, inversions):
    """The JAX bf16 artifact (no early stop) replayed under its own prompt:
    in bf16 by both packages and in f32 by the port; the final latents."""
    jpipe, ppipe = pipes
    art, _ = inversions("jax", TB, -1.0)
    x_t = np.asarray(art.x_t.astype(jnp.float32))
    uncond = art.uncond_embeddings
    cfg = jpipe.config
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None, 1, JB)
    _, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, cfg, j_unet_layout(cfg.unet),
        jsched.schedule_from_config(STEPS, cfg.scheduler, kind="ddim"), "ddim",
        jsampler.encode_prompts(jpipe, [PROMPT], dtype=JB),
        jsampler.encode_prompts(jpipe, [""], dtype=JB), lat, None,
        jnp.float32(cfg.guidance_scale), jnp.asarray(uncond), False)
    j16 = np.asarray(latents.astype(jnp.float32))
    p = {}
    for pdt in (torch.float32, TB):
        _, _, _, lat_p = text2image(ppipe, [PROMPT], None, num_steps=STEPS,
                                    latent=torch.from_numpy(x_t),
                                    uncond_embeddings=torch.from_numpy(uncond),
                                    dtype=pdt, device="cpu", return_latents=True)
        assert lat_p.dtype == pdt
        p[pdt] = lat_p.float().numpy()
    _hold("replay latents", j16, p[TB], p[torch.float32])


def test_jax_bf16_artifact_loads_exactly(inversions, tmp_path):
    art, _ = inversions("jax", TB, 1e9)
    path = str(tmp_path / "jax_bf16.npz")
    art.save(path)
    assert np.load(path)["x_t"].dtype == np.dtype("V2")
    loaded = pinv.InversionArtifact.load(path)
    assert loaded.x_t.dtype == np.float32
    np.testing.assert_array_equal(loaded.x_t, np.asarray(art.x_t.astype(np.float32)))
    np.testing.assert_array_equal(loaded.uncond_embeddings, art.uncond_embeddings)


def test_invert_refuses_float16(pipes, image):
    _, ppipe = pipes
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        pinv.invert(ppipe, image, PROMPT, num_steps=STEPS, num_inner_steps=INNER,
                    dtype=torch.float16, device="cpu")


# The f32 code before the bf16 path, where it changed: the plain K3 and K4
# passes, K4's di, and the CFG step of the inner loss and the advance.

def _parent_residuals_plain(q, k, v, scale, chunk=1024):
    outs, ls, ms = [], [], []
    for s0 in range(0, q.shape[-2], chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[..., s0:s0 + chunk, :].float(),
                         k.float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l[..., None])
        ls.append(l)
        ms.append(m)
    return (torch.cat(outs, dim=-2).to(v.dtype), torch.cat(ls, dim=-1),
            torch.cat(ms, dim=-1))


def _parent_dkv_plain(q, k, v, do, l, m, di, scale, chunk=1024):
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        qc, doc = q[..., sl, :], do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qc, k) * scale - lse[..., sl, None])
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, doc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doc, v) - di[..., sl, None])
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
    return dk, dv


def _parent_dq_plain(q, k, v, do, l, m, di, scale, chunk=1024):
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dqs = []
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        doc = do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q[..., sl, :], k) * scale
                      - lse[..., sl, None])
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doc, v) - di[..., sl, None])
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale)
    return torch.cat(dqs, dim=-2)


def _parent_bwd(q, k, v, o, do, l, m, scale):
    di = (o * do).sum(dim=-1)
    dk, dv = pflash_bwd.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
    return pflash_bwd.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale), dk, dv


def _parent_cfg_eps(pipe, schedule, latent, t, uncond, eps_cond, guidance_scale):
    eps_u, _ = apply_unet(pipe.unet, pipe.config.unet, latent, t, uncond)
    eps = eps_u + guidance_scale * (eps_cond - eps_u)
    return psched.to_epsilon(schedule, eps, t, latent)


def test_f32_inversion_bitwise_unchanged(pipes, image, inversions, monkeypatch):
    _, ppipe = pipes
    now, _ = inversions("port", torch.float32, -1.0)
    monkeypatch.setattr(pflash, "flash_attention_residuals_plain", _parent_residuals_plain)
    monkeypatch.setattr(pflash_bwd, "flash_attention_bwd_dkv_plain", _parent_dkv_plain)
    monkeypatch.setattr(pflash_bwd, "flash_attention_bwd_dq_plain", _parent_dq_plain)
    monkeypatch.setattr(pflash_bwd, "flash_attention_bwd", _parent_bwd)
    monkeypatch.setattr(pinv, "_cfg_eps", _parent_cfg_eps)
    before = pinv.invert(ppipe, image, PROMPT, num_steps=STEPS, num_inner_steps=INNER,
                         early_stop_epsilon=-1.0, device="cpu")
    for name in ("x_t", "uncond_embeddings", "image_rec"):
        np.testing.assert_array_equal(getattr(now, name), getattr(before, name), name)
    assert now.inner_steps == before.inner_steps
