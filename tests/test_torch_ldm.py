"""The port's LDM-256 backend against the JAX package's, on TINY_LDM: the
configs and name tables, the LDMBert text encoder, the VQ autoencoder's
``quantize``, encode and decode, a Replace edit through ``text2image`` in
f32 (materialized and with the kernels) and bf16, and the CLI.

Same weights on both sides (made with numpy in the JAX package's init
scheme, loaded by ``from_jax_params``), inputs made with numpy from a seed,
one shared x_T. Bars: the encoder and the autoencoder's
halves within f32 rounding (≤ 1e-4, 1e-5); ``quantize`` picks the JAX
package's codebook index for every vector, or, where it does not, one whose
distance lies within f32 rounding of the JAX pick's; the edit as
``tests/test_torch_pipeline.py`` (final latents ≤ 1e-3, uint8 images max ≤ 3
and mean ≤ 0.5), and in bf16 as ``tests/test_torch_bf16_pipeline.py`` (√2
times the JAX package's own bf16-vs-f32 distance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402
from p2p_tpu.models import checkpoint as j_ck, config as j_config  # noqa: E402
from p2p_tpu.models import init_text_encoder, init_unet, vae as jvae  # noqa: E402
from p2p_tpu.models.text_encoder import apply_text_encoder as j_text  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.engine.sampler import Pipeline, text2image  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck, config as p_config  # noqa: E402
from p2p_tpu_torch.models import vae as pvae  # noqa: E402
from p2p_tpu_torch.models.text_encoder import apply_text_encoder  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402
from tests.test_torch_bf16_inversion import _weights, few_threads  # noqa: E402,F401
from tests.test_torch_bf16_pipeline import BF16_BAR, _dist  # noqa: E402

PROMPTS = ["a cat riding a bike", "a dog riding a bike"]
STEPS = 3
SEED = 6
L = 16
VOCAB = j_config.TINY_LDM.text.vocab_size


def _toks():
    return (JTok(vocab_size=VOCAB, model_max_length=L),
            PTok(vocab_size=VOCAB, model_max_length=L))


def numpy_weights(cfg, rng):
    """``cfg``'s parameter trees (U-Net, text encoder, VAE) in the JAX
    package's init scheme, made with numpy (``_weights``, no JAX compile),
    a VQ codebook uniform in ±1/K as the JAX init draws it."""
    vae = _weights(jvae.init_vae, cfg.vae, rng)
    if "codebook" in vae:
        k = cfg.vae.num_codebook
        vae["codebook"] = rng.uniform(-1 / k, 1 / k, vae["codebook"].shape).astype(np.float32)
    return (_weights(init_unet, cfg.unet, rng),
            _weights(init_text_encoder, cfg.text, rng), vae)


def numpy_pipes(name, toks, seed):
    """The JAX pipeline of config ``name`` and the port's, holding the same
    numpy-made weights, with tokenizers ``toks`` (JAX's, the port's)."""
    jcfg, pcfg = getattr(j_config, name), getattr(p_config, name)
    tree = numpy_weights(jcfg, np.random.default_rng(seed))
    jpipe = jsampler.Pipeline(
        config=jcfg, unet_params=jax.tree.map(jnp.asarray, tree[0]),
        text_params=jax.tree.map(jnp.asarray, tree[1]),
        vae_params=jax.tree.map(jnp.asarray, tree[2]), tokenizer=toks[0])
    ppipe = Pipeline(
        config=pcfg,
        unet=ck.from_jax_params(tree[0], ck.unet_entries(pcfg.unet)),
        text_encoder=ck.from_jax_params(tree[1], ck.encoder_entries(pcfg.text)),
        vae=ck.from_jax_params(tree[2], ck.vae_entries(pcfg.vae)),
        tokenizer=toks[1])
    return jpipe, ppipe


@pytest.fixture(scope="module")
def pipes():
    return numpy_pipes("TINY_LDM", _toks(), 2)


@pytest.mark.parametrize("name", ["LDM256", "TINY_LDM"])
def test_configs_and_name_tables(name):
    jc, pc = getattr(j_config, name), getattr(p_config, name)
    from tests.test_torch_copies import dataclass_dict

    assert dataclass_dict(pc) == dataclass_dict(jc)
    assert p_config.unet_attn_specs(pc.unet) == j_config.unet_attn_specs(jc.unet)
    assert ck.unet_entries(pc.unet) == j_ck.unet_entries(jc.unet)
    assert ck.ldm_text_encoder_entries(pc.text) == j_ck.ldm_text_encoder_entries(jc.text)
    assert ck.encoder_entries(pc.text) == j_ck.ldm_text_encoder_entries(jc.text)
    assert ck.vae_entries(pc.vae) == j_ck.vae_entries(jc.vae)
    for init, entries, cfg in ((ck.init_unet, ck.unet_entries, pc.unet),
                               (ck.init_text_encoder, ck.encoder_entries, pc.text),
                               (ck.init_vae, ck.vae_entries, pc.vae)):
        assert set(init(cfg, None, "meta")) == {n for _, n, _ in entries(cfg)}


def test_random_init_shapes_match_jax_init():
    """The port's random LDM weights have the JAX init's shapes, leaf by
    leaf (the VQ encoder's narrow conv_out and the codebook included)."""
    cfg = p_config.TINY_LDM
    _, text, vae = numpy_weights(j_config.TINY_LDM, np.random.default_rng(0))
    for init, tree, entries, c in ((ck.init_text_encoder, text, ck.encoder_entries, cfg.text),
                                   (ck.init_vae, vae, ck.vae_entries, cfg.vae)):
        want = ck.from_jax_params(tree, entries(c))
        got = init(c, 0, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
    cb = ck.init_vae(cfg.vae, 0, "cpu")["quantize.embedding.weight"]
    assert cb.abs().max() <= 1.0 / cfg.vae.num_codebook


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ldmbert_encoder_matches_jax(pipes, dtype):
    """Non-causal, rectangular attention (32 wide at TINY, 512 of 1280 at
    LDM-256), no q/k/v bias, gelu; in bf16 within the JAX program's
    rounding (2e-2 of the largest magnitude, the bf16 modules' bar)."""
    jpipe, ppipe = pipes
    ids = np.random.RandomState(3).randint(0, VOCAB, size=(2, L))
    jd, pd = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(j_text(jpipe.text_params, jpipe.config.text,
                             jnp.asarray(ids, jnp.int32), dtype=jd).astype(jnp.float32))
    got = apply_text_encoder(ppipe.weights(pd)[1], ppipe.config.text,
                             torch.from_numpy(ids), dtype=pd)
    assert got.dtype == pd and got.shape == (2, L, 32)
    tol = 1e-4 if dtype == "f32" else 2e-2 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


def _indices(q, cb):
    """The codebook row each vector of a quantized ``q`` is (a gather of
    ``cb`` rows, so each matches one row exactly)."""
    eq = (q.reshape(-1, 1, cb.shape[1]) == cb[None]).all(-1)
    assert (eq.sum(1) == 1).all()
    return eq.argmax(1)


@pytest.mark.parametrize("case", ["codebook_scale", "near_entries"])
def test_quantize_matches_jax(case):
    """Indices equal to the JAX package's, or, where one differs, the two
    entries' distances within f32 rounding of each other."""
    rng = np.random.RandomState(4)
    cb = rng.uniform(-1 / 64, 1 / 64, (64, 4)).astype(np.float32)
    if case == "codebook_scale":
        z = rng.uniform(-1 / 64, 1 / 64, (2, 16, 16, 4)).astype(np.float32)
    else:     # entries plus a little noise: near ties between neighbours
        z = (cb[rng.randint(0, 64, (2, 16, 16))]
             + 1e-4 * rng.randn(2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jvae.quantize({"codebook": jnp.asarray(cb)}, None, jnp.asarray(z)))
    got = pvae.quantize({"quantize.embedding.weight": torch.from_numpy(cb)},
                        torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == z.shape
    gi, wi = _indices(got, cb), _indices(want, cb)
    flat, c64 = z.reshape(-1, 4).astype(np.float64), cb.astype(np.float64)
    d = ((flat[:, None] - c64[None]) ** 2).sum(-1)          # exact distances
    scale = (flat * flat).sum(-1) + (c64 * c64).sum(-1).max()
    for r in np.nonzero(gi != wi)[0]:
        assert abs(d[r, gi[r]] - d[r, wi[r]]) <= 4 * np.finfo(np.float32).eps * scale[r]
    assert (gi != wi).mean() <= 0.01


def test_vq_encode_and_decode_match_jax(pipes):
    jpipe, ppipe = pipes
    cfg = ppipe.config.vae
    rng = np.random.RandomState(5)
    image = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jvae.encode(jpipe.vae_params, jpipe.config.vae, jnp.asarray(image)))
    got = pvae.encode(ppipe.vae, cfg, torch.from_numpy(image)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-5
    # Decode latents near codebook entries (× 0.18215), so the snap is
    # decided far from ties, and the decode itself is compared.
    cb = np.asarray(jpipe.vae_params["codebook"])
    lat = (cb[rng.randint(0, len(cb), (2, 16, 16))] * cfg.scaling_factor).astype(np.float32)
    want = np.asarray(jvae.decode(jpipe.vae_params, jpipe.config.vae, jnp.asarray(lat)))
    got = pvae.decode(ppipe.vae, cfg, torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert np.abs(got - want).max() <= 1e-5


def controllers(steps=STEPS, store=False):
    jt, pt = _toks()
    kw = dict(max_len=L, store=store)
    return (jfactory.attention_replace(PROMPTS, steps, 0.8, 0.4, jt, **kw),
            pfactory.attention_replace(PROMPTS, steps, 0.8, 0.4, pt, **kw))


def jax_run(jpipe, controller, x_t, kernels, dtype=jnp.float32, scheduler="ddim",
            steps=STEPS, prompts=PROMPTS):
    """The JAX ungated text2image program: (uint8 images, final latents as
    f32)."""
    from p2p_tpu.models.config import unet_layout as j_unet_layout

    cfg = jpipe.config
    ctx_c = jsampler.encode_prompts(jpipe, prompts, dtype=dtype)
    ctx_u = jsampler.encode_prompts(jpipe, [""] * len(prompts), dtype=dtype)
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None,
                                  len(prompts), dtype)
    image, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, cfg, j_unet_layout(cfg.unet),
        jsched.schedule_from_config(steps, cfg.scheduler, kind=scheduler),
        scheduler, ctx_c, ctx_u, lat, controller,
        jnp.float32(cfg.guidance_scale), None, False, kernels=kernels)
    return np.asarray(image), np.asarray(latents.astype(jnp.float32))


def port_run(ppipe, controller, x_t, kernels, dtype=torch.float32,
             scheduler="ddim", steps=STEPS, prompts=PROMPTS):
    img, xt, _, lat = text2image(
        ppipe, prompts, controller, num_steps=steps, latent=torch.from_numpy(x_t),
        kernels=kernels, device="cpu", return_latents=True, dtype=dtype,
        scheduler=scheduler)
    side = ppipe.config.image_size
    assert img.dtype == torch.uint8 and img.shape == (len(prompts), side, side, 3)
    assert lat.dtype == dtype and torch.isfinite(lat).all()
    np.testing.assert_array_equal(xt.float().numpy(),
                                  torch.from_numpy(x_t).to(dtype).float().numpy())
    return img.numpy(), lat.float().numpy()


def assert_f32_match(p, j):
    assert np.abs(p[1] - j[1]).max() <= 1e-3, np.abs(p[1] - j[1]).max()
    d = np.abs(p[0].astype(np.int16) - j[0].astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())


X_T = np.random.RandomState(SEED).randn(1, 16, 16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def jax_f32_edit(pipes):
    """The JAX package's materialized f32 edit, for the f32 and bf16 tests."""
    return jax_run(pipes[0], controllers()[0], X_T, None)


@pytest.mark.parametrize("kernels", ["none", "fused"])
def test_replace_edit_matches_jax(pipes, jax_f32_edit, kernels):
    """The Replace edit on TINY_LDM (CFG 5.0, the LDM β schedule), the
    materialized path on both sides, or the port's kernels (their plain
    versions on the CPU) against JAX's Pallas kernels in interpret mode."""
    jpipe, ppipe = pipes
    jc, pc = controllers()
    want = (jax_run(jpipe, jc, X_T, JKernelConfig(interpret=True)) if kernels == "fused"
            else jax_f32_edit)
    assert_f32_match(port_run(ppipe, pc, X_T, KernelConfig() if kernels == "fused"
                              else None), want)


def test_replace_edit_bf16_matches_jax_bf16(pipes, jax_f32_edit):
    jpipe, ppipe = pipes
    x_t = X_T
    jc, pc = controllers()
    j32 = jax_f32_edit
    j16 = jax_run(jpipe, jc, x_t, None, jnp.bfloat16)
    p16 = port_run(ppipe, pc, x_t, None, torch.bfloat16)
    bar, got = _dist(j16, j32), _dist(p16, j16)
    msg = f"port-vs-JAX bf16 {got}; JAX bf16-vs-f32 {bar}"
    print(msg)
    assert all(b > 0 for b in bar), msg
    assert all(g <= BF16_BAR * b for g, b in zip(got, bar)), msg


def test_cli_edit_tiny_ldm(tmp_path):
    from p2p_tpu_torch.cli import main

    out = tmp_path / "out"
    assert main(["edit", "--preset", "tiny_ldm", "--device", "cpu", "--mode",
                 "replace", "--source", "a cat riding a bike", "--target",
                 "a dog riding a bike", "--steps", "2", "--scheduler", "plms",
                 "--kernels", "--quiet", "--out-dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["08191_y.jpg", "08191_y_hat.jpg"]
    for cmd in ("invert", "replay"):
        args = (["--image", "x.png", "--prompt", "a cat"] if cmd == "invert"
                else ["--artifact", "x.npz"])
        with pytest.raises(SystemExit, match="no null-text inversion at LDM"):
            main([cmd, "--preset", "tiny_ldm", "--device", "cpu", *args])
