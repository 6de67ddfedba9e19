"""The port's null-text replay edit against the JAX package's, on TINY:
LocalBlend, Reweight, ``make_controller`` with both, and ``text2image``
with per-step ``uncond_embeddings``; the dispatch of that controller; and
the CLI's ``invert`` → ``replay`` round trip.

TINY stores the cross maps of its 8² level only, so LocalBlend runs at
``blend_resolution=8`` (SD-1.4's default is 16). Same weights on both sides
(``from_jax_params``); inputs made with numpy from a seed. Bars: the blend
and the factory are exact up to f32 rounding (≤ 1e-6); ``text2image`` as
``tests/test_torch_pipeline.py``: final latents ≤ 1e-3 (3 steps of U-Net
rounding in different orders, amplified by CFG 7.5), uint8 images max ≤ 3
and mean ≤ 0.5 (the JAX suite's golden-image tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import blend as jblend  # noqa: E402
from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import KernelConfig as JKernelConfig  # noqa: E402
from p2p_tpu.kernels import site_variant as j_site_variant  # noqa: E402
from p2p_tpu.models import SD14 as J_SD14, TINY as J_TINY  # noqa: E402
from p2p_tpu.models.config import unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch.controllers import blend as pblend  # noqa: E402
from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.engine.sampler import text2image  # noqa: E402
from p2p_tpu_torch.kernels import KernelConfig, site_variant  # noqa: E402
from p2p_tpu_torch.models.config import SD14, TINY, unet_layout  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402
from tests.test_torch_pipeline import make_pipes  # noqa: E402

PROMPTS = ["a cat riding a bike", "a dog riding a bike"]
STEPS = 3
BLEND = (("cat",), ("dog",))
EQ = {"words": ("dog",), "values": (2.0,)}


def _controllers(prompts=PROMPTS, steps=STEPS, L=16, res=8, **kw):
    common = dict(is_replace_controller=True, cross_replace_steps=0.8,
                  self_replace_steps=0.4, num_steps=steps, blend_words=BLEND,
                  equalizer_params=EQ, blend_resolution=res, **kw)
    return (jfactory.make_controller(prompts, tokenizer=JTok(model_max_length=L), **common),
            pfactory.make_controller(prompts, tokenizer=PTok(model_max_length=L), **common))


def _eq(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=0, atol=1e-6)


def test_local_blend_and_reweight_parameters_match_jax():
    jt, pt = JTok(model_max_length=16), PTok(model_max_length=16)
    kw = dict(substruct_words=(("bike",), ("bike",)), start_blend=0.4,
              num_steps=5, th=(0.25, 0.35), resolution=8)
    jb = jfactory.local_blend(PROMPTS, BLEND, jt, **kw)
    pb = pfactory.local_blend(PROMPTS, BLEND, pt, **kw)
    _eq(pb.alpha_layers, jb.alpha_layers)
    _eq(pb.substruct_layers, jb.substruct_layers)
    assert (pb.start_blend, pb.resolution) == (int(jb.start_blend), jb.resolution)
    assert np.float32(pb.th_pool) == jb.th_pool and np.float32(pb.th_nopool) == jb.th_nopool

    jc, pc = _controllers()
    for name in ("cross_alpha", "mapper", "refine_alphas", "equalizer"):
        _eq(getattr(pc.edit, name), getattr(jc.edit, name))
    assert (pc.edit.kind, pc.edit.self_max_pixels, pc.store) == (
        jc.edit.kind, jc.edit.self_max_pixels, jc.store)
    assert (pc.edit.self_start, pc.edit.self_end) == (int(jc.edit.self_start),
                                                      int(jc.edit.self_end))
    _eq(pc.blend.alpha_layers, jc.blend.alpha_layers)
    assert pc.blend.start_blend == int(jc.blend.start_blend)

    # Reweight alone, and stacked on a Reweight (the equalizers multiply).
    eq = np.array([[1.0] * 3 + [3.0] + [1.0] * 12], np.float32)
    jr = jfactory.attention_reweight(PROMPTS, 5, 0.8, 0.4, eq, jt, max_len=16)
    pr = pfactory.attention_reweight(PROMPTS, 5, 0.8, 0.4, eq, pt, max_len=16)
    jr2 = jfactory.attention_reweight(PROMPTS, 5, 0.8, 0.4, eq, jt, base=jr, max_len=16)
    pr2 = pfactory.attention_reweight(PROMPTS, 5, 0.8, 0.4, eq, pt, base=pr, max_len=16)
    for j, p in ((jr, pr), (jr2, pr2)):
        assert p.edit.kind == j.edit.kind == "none"
        _eq(p.edit.equalizer, j.edit.equalizer)
        _eq(p.edit.cross_alpha, j.edit.cross_alpha)


@pytest.mark.parametrize("substruct", [False, True])
def test_apply_local_blend_matches_jax(substruct):
    jt, pt = JTok(model_max_length=16), PTok(model_max_length=16)
    kw = dict(start_blend=0.4, num_steps=5, resolution=8,
              substruct_words=(("bike",), ("bike",)) if substruct else None)
    jb = jfactory.local_blend(PROMPTS, BLEND, jt, **kw)
    pb = pfactory.local_blend(PROMPTS, BLEND, pt, **kw)
    jl, pl = j_unet_layout(J_TINY.unet), unet_layout(TINY.unet)
    assert [m.layer_idx for m in pl.blend_metas(8)] == [
        m.layer_idx for m in jl.blend_metas(8)]
    rng = np.random.RandomState(3)
    state = tuple(rng.rand(2, m.heads, m.pixels, m.key_len).astype(np.float32)
                  for m in pl.stored_metas())
    x_t = rng.randn(2, 16, 16, 4).astype(np.float32)
    for step in (0, 1, 2, 4):
        want = jblend.apply_local_blend(jb, jl, tuple(map(jnp.asarray, state)),
                                        jnp.asarray(x_t), jnp.int32(step))
        got = pblend.apply_local_blend(pb, pl, tuple(map(torch.from_numpy, state)),
                                       torch.from_numpy(x_t), step)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6, step
    # The blend changed something past start_blend (not a vacuous check).
    assert not np.array_equal(got.numpy(), x_t)


def _jax_replay(jpipe, controller, x_t, uncond, kernels):
    cfg = jpipe.config
    ctx_c = jsampler.encode_prompts(jpipe, PROMPTS)
    ctx_u = jsampler.encode_prompts(jpipe, [""] * len(PROMPTS))
    _, lat = jsampler.init_latent(jnp.asarray(x_t), jpipe.latent_shape, None,
                                  len(PROMPTS))
    image, latents, _ = jsampler._text2image_jit(
        jpipe.unet_params, jpipe.vae_params, cfg, j_unet_layout(cfg.unet),
        jsched.schedule_from_config(STEPS, cfg.scheduler, kind="ddim"), "ddim",
        ctx_c, ctx_u, lat, controller, jnp.float32(cfg.guidance_scale),
        jnp.asarray(uncond), False, kernels=kernels)
    return np.asarray(image), np.asarray(latents)


@pytest.mark.parametrize("kernels", ["none", "fused"])
def test_replay_text2image_matches_jax(kernels):
    """Replace + LocalBlend + Reweight with per-step uncond embeddings; the
    port's ``KernelConfig()`` (K2's plain version on the CPU) against the
    JAX ``KernelConfig(interpret=True)`` (the Pallas kernel interpreted)."""
    jpipe, ppipe = make_pipes()
    rng = np.random.RandomState(7)
    x_t = rng.randn(1, 16, 16, 4).astype(np.float32)
    uncond = rng.randn(STEPS, 1, 16, 32).astype(np.float32)
    jc, pc = _controllers()
    jk, pk = ((JKernelConfig(interpret=True), KernelConfig()) if kernels == "fused"
              else (None, None))
    j_img, j_lat = _jax_replay(jpipe, jc, x_t, uncond, jk)
    p_img, _, _, p_lat = text2image(
        ppipe, PROMPTS, pc, num_steps=STEPS, latent=torch.from_numpy(x_t),
        uncond_embeddings=torch.from_numpy(uncond), kernels=pk, device="cpu",
        return_latents=True)
    assert np.abs(p_lat.numpy() - j_lat).max() <= 1e-3
    d = np.abs(p_img.numpy().astype(np.int16) - j_img.astype(np.int16))
    assert d.max() <= 3 and d.mean() <= 0.5, (d.max(), d.mean())
    # The substituted embeddings matter: the raw "" uncond gives another run.
    _, _, _, raw = text2image(ppipe, PROMPTS, pc, num_steps=STEPS,
                              latent=torch.from_numpy(x_t), kernels=pk,
                              device="cpu", return_latents=True)
    assert np.abs(raw.numpy() - p_lat.numpy()).max() > 1e-2


def test_uncond_embeddings_rejections():
    _, ppipe = make_pipes()
    ups = torch.zeros(STEPS, 1, 16, 32)
    kw = dict(num_steps=STEPS, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        text2image(ppipe, PROMPTS, None, uncond_embeddings=ups,
                   negative_prompt="blurry", **kw)
    with pytest.raises(ValueError, match="ddim"):
        text2image(ppipe, PROMPTS, None, uncond_embeddings=ups,
                   scheduler="plms", **kw)
    with pytest.raises(ValueError, match="steps"):
        text2image(ppipe, PROMPTS, None, uncond_embeddings=ups[:2], **kw)
    with pytest.raises(NotImplementedError, match="gate"):
        text2image(ppipe, PROMPTS, None, uncond_embeddings=ups, gate=2, **kw)


@pytest.mark.parametrize("cfg_pair", [(J_SD14, SD14), (J_TINY, TINY)],
                         ids=["sd14", "tiny"])
def test_site_variant_blend_reweight_matches_jax(cfg_pair):
    jcfg, pcfg = cfg_pair
    L = jcfg.text.max_length
    res = 16 if jcfg is J_SD14 else 8
    jc, pc = _controllers(["a cat on a mat", "a dog on a mat"], 50, L, res)
    assert pc.needs_store and jc.needs_store
    got = [site_variant(KernelConfig(), pc, m) for m in unet_layout(pcfg.unet).metas]
    want = [j_site_variant(JKernelConfig(), jc, m, "off")
            for m in j_unet_layout(jcfg.unet).metas]
    assert got == want
    if jcfg is J_SD14:
        counts = {v: got.count(v) for v in set(got)}
        assert counts == {"fused-edit": 5, "flash": 5, "materialized": 22}


def test_cli_invert_then_replay(tmp_path):
    from PIL import Image

    from p2p_tpu_torch.cli import main
    from p2p_tpu_torch.engine.inversion import InversionArtifact

    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (80, 100, 3), dtype=np.uint8)).save(img)
    art = tmp_path / "inv.npz"
    assert main(["invert", "--preset", "tiny", "--device", "cpu", "--image",
                 str(img), "--prompt", "a cat riding a bike", "--steps", "2",
                 "--inner-steps", "2", "--artifact", str(art), "--quiet",
                 "--out-dir", str(tmp_path / "inv")]) == 0
    loaded = InversionArtifact.load(str(art))
    assert loaded.uncond_embeddings.shape == (2, 1, 16, 32)
    assert sorted(p.name for p in (tmp_path / "inv").iterdir()) == [
        "gt.png", "vae_rec.png"]
    out = tmp_path / "replay"
    assert main(["replay", "--preset", "tiny", "--device", "cpu", "--artifact",
                 str(art), "--mode", "replace", "--target", "a dog riding a bike",
                 "--blend-words", "cat,dog", "--blend-resolution", "8",
                 "--equalizer", "dog=2", "--kernels", "--quiet",
                 "--out-dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["edited.png",
                                                     "reconstruction.png"]
    with pytest.raises(SystemExit, match="--batch-targets is not supported"):
        main(["replay", "--device", "cpu", "--artifact", str(art), "--target",
              "a dog", "--batch-targets"])
