"""Module-by-module f32 parity of the port against the JAX package.

The JAX side's random weights are carried into the port through
``checkpoint.from_jax_params``; inputs are made with numpy from a seed and
handed to both. Both sides compute in f32 on the CPU; only the order of
the sums inside convolutions, matmuls and reductions differs, so
primitives agree to ~1e-5 and deeper stacks accumulate more of that
rounding (stated per test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.models import nn as jnn, unet as junet, vae as jvae  # noqa: E402
from p2p_tpu.models.config import TINY as J_TINY, unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.models.text_encoder import (  # noqa: E402
    apply_text_encoder as j_text, init_text_encoder as j_init_text)
from p2p_tpu.ops import schedulers as jsched  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch.controllers import factory as pfactory  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck, nn, unet, vae  # noqa: E402
from p2p_tpu_torch.models.config import TINY, unet_layout  # noqa: E402
from p2p_tpu_torch.models.text_encoder import apply_text_encoder  # noqa: E402
from p2p_tpu_torch.ops import schedulers as sched  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer as PTok  # noqa: E402

PRIM_TOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _maxdiff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.detach().numpy() - _np(want)).max())


@pytest.fixture(scope="module")
def jparams():
    return {
        "unet": junet.init_unet(jax.random.PRNGKey(0), J_TINY.unet),
        "text": j_init_text(jax.random.PRNGKey(1), J_TINY.text),
        "vae": jvae.init_vae(jax.random.PRNGKey(2), J_TINY.vae),
    }


@pytest.fixture(scope="module")
def psd(jparams):
    np_tree = jax.tree.map(np.asarray, jparams)
    return {
        "unet": ck.from_jax_params(np_tree["unet"], ck.unet_entries(TINY.unet)),
        "text": ck.from_jax_params(np_tree["text"], ck.text_encoder_entries(TINY.text)),
        "vae": ck.from_jax_params(np_tree["vae"], ck.vae_entries(TINY.vae)),
    }


# ------------------------------------------------------------ primitives

def test_linear_conv_and_norms():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 6, 16).astype(np.float32)
    w_lin, b_lin = rng.randn(16, 8).astype(np.float32), rng.randn(8).astype(np.float32)
    got = nn.linear(_t(x), _t(w_lin.T), _t(b_lin))
    assert _maxdiff(got, jnn.linear({"kernel": w_lin, "bias": b_lin}, x)) <= PRIM_TOL

    w = rng.randn(3, 3, 16, 8).astype(np.float32) * 0.1
    b = rng.randn(8).astype(np.float32)
    w_t = _t(np.transpose(w, (3, 2, 0, 1)))
    for stride, pad_j, pad_p in ((1, "SAME", None), (2, 1, 1)):
        got = nn.conv2d(_nchw(x), w_t, _t(b), stride=stride, padding=pad_p)
        want = jnn.conv2d({"kernel": w, "bias": b}, x, stride=stride, padding=pad_j)
        assert _maxdiff(got.permute(0, 2, 3, 1), want) <= PRIM_TOL

    scale, shift = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    p = {"scale": scale, "bias": shift}
    for groups, eps in ((8, 1e-5), (4, 1e-6), (32, 1e-5)):   # 32 > C: min(g, C)
        got = nn.group_norm(_nchw(x), _t(scale), _t(shift), groups, eps)
        want = jnn.group_norm(p, jnp.asarray(x), groups, eps)
        assert _maxdiff(got.permute(0, 2, 3, 1), want) <= PRIM_TOL
    got = nn.layer_norm(_t(x), _t(scale), _t(shift))
    assert _maxdiff(got, jnn.layer_norm(p, jnp.asarray(x))) <= PRIM_TOL


def test_activations_upsample_and_timestep_embedding():
    x = np.random.RandomState(1).randn(2, 5, 5, 3).astype(np.float32) * 3
    for pf, jf in ((nn.silu, jnn.silu), (nn.gelu, jnn.gelu),
                   (nn.quick_gelu, jnn.quick_gelu)):
        assert _maxdiff(pf(_t(x)), jf(jnp.asarray(x))) <= PRIM_TOL
    got = nn.upsample_nearest_2x(_nchw(x)).permute(0, 2, 3, 1)
    assert _maxdiff(got, jnn.upsample_nearest_2x(jnp.asarray(x))) == 0.0
    t = np.array([0, 1, 981, 999], np.int64)
    for dim in (32, 33):
        got = nn.timestep_embedding(torch.from_numpy(t), dim)
        want = jnn.timestep_embedding(jnp.asarray(t, jnp.int32), dim)
        # sin/cos of arguments up to 999 rad: f32 argument rounding alone is
        # ~6e-5 rad there, so the two libms agree to ~1e-4, not 1e-5.
        assert _maxdiff(got, want) <= 1e-4


def test_attention_probs_and_fused_attention():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 2, 16, 8).astype(np.float32) for _ in range(3))
    mask = np.triu(np.full((16, 16), -1e9, np.float32), k=1)[None, None]
    got = nn.attention_probs(_t(q), _t(k), 0.3, _t(mask))
    assert _maxdiff(got, jnn.attention_probs(q, k, 0.3, mask)) <= PRIM_TOL
    got = nn.fused_attention(_t(q), _t(k), _t(v), 0.3)
    assert _maxdiff(got, jnn.fused_attention(q, k, v, 0.3)) <= PRIM_TOL


# ------------------------------------------------------------ blocks

def test_text_encoder(jparams, psd):
    ids = np.random.RandomState(3).randint(0, 49408, size=(2, 16))
    got = apply_text_encoder(psd["text"], TINY.text, torch.from_numpy(ids))
    want = j_text(jparams["text"], J_TINY.text, jnp.asarray(ids, jnp.int32))
    assert _maxdiff(got, want) <= 1e-4   # 2 layers of LN-normalized O(1) states


def test_resnet_and_spatial_transformer(jparams, psd):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    temb = rng.randn(2, 128).astype(np.float32)
    got = unet._apply_resnet(psd["unet"], "down_blocks.0.resnets.0", _nchw(x),
                             _t(temb), J_TINY.unet.groups)
    want = junet._apply_resnet(jparams["unet"]["down"][0]["resnets"][0], x,
                               temb, J_TINY.unet.groups)
    assert _maxdiff(got.permute(0, 2, 3, 1), want) <= 1e-4

    ctx = rng.randn(2, 16, 32).astype(np.float32)
    jctx = junet._HookCtx(j_unet_layout(J_TINY.unet), None, (), jnp.int32(0))
    pctx = unet._HookCtx(unet_layout(TINY.unet), None, (), 0, None)
    got = unet._apply_spatial_transformer(psd["unet"], "down_blocks.0.attentions.0",
                                          _nchw(x), _t(ctx), TINY.unet, pctx)
    want = junet._apply_spatial_transformer(
        jparams["unet"]["down"][0]["attns"][0], x, ctx, J_TINY.unet, jctx)
    assert _maxdiff(got.permute(0, 2, 3, 1), want) <= 1e-4
    assert pctx.cursor == jctx.cursor == 2


def _controllers(store):
    prompts = ["a cat riding a bike", "a dog riding a bike"]
    kw = dict(max_len=16, self_max_pixels=256, store=store)
    jc = jfactory.attention_replace(prompts, 3, 0.8, 0.4,
                                    JTok(model_max_length=16), **kw)
    pc = pfactory.attention_replace(prompts, 3, 0.8, 0.4,
                                    PTok(model_max_length=16), **kw)
    return jc, pc


@pytest.mark.parametrize("with_controller", [False, True])
def test_apply_unet(jparams, psd, with_controller):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(4, 16, 32).astype(np.float32)
    jc, pc = _controllers(store=True) if with_controller else (None, None)
    jl, pl = j_unet_layout(J_TINY.unet), unet_layout(TINY.unet)
    jstate = pstate = ()
    if with_controller:
        from p2p_tpu.controllers.base import init_store_state as j_init_store
        from p2p_tpu_torch.controllers.base import init_store_state

        jstate, pstate = j_init_store(jl, 2), init_store_state(pl, 2)
    want, jstate = junet.apply_unet(jparams["unet"], J_TINY.unet, x, 981, ctx,
                                    layout=jl, controller=jc, state=jstate,
                                    step=jnp.int32(0))
    got, pstate = unet.apply_unet(psd["unet"], TINY.unet, _t(x), 981, _t(ctx),
                                  layout=pl, controller=pc, state=pstate, step=0)
    # The ε of a whole (random-weight) U-Net: some 30 conv / attention
    # layers of f32 rounding in a different summation order.
    assert _maxdiff(got, want) <= 1e-4
    assert len(pstate) == len(jstate)
    for g, w in zip(pstate, jstate):
        assert _maxdiff(g, w) <= 1e-5          # stored probabilities


def test_vae_decode_and_uint8(jparams, psd):
    lat = np.random.RandomState(6).randn(2, 16, 16, 4).astype(np.float32) * 0.2
    got = vae.decode(psd["vae"], TINY.vae, _t(lat))
    want = jvae.decode(jparams["vae"], J_TINY.vae, jnp.asarray(lat))
    assert got.shape == (2, 64, 64, 3)
    assert _maxdiff(got, want) <= 1e-4
    img = np.linspace(-1.2, 1.2, 97, dtype=np.float32)
    np.testing.assert_array_equal(vae.to_uint8(_t(img)).numpy(),
                                  np.asarray(jvae.to_uint8(jnp.asarray(img))))


def test_ddim_schedule_and_step():
    js = jsched.make_schedule(10)
    ps = sched.make_schedule(10)
    np.testing.assert_array_equal(ps.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    rng = np.random.RandomState(7)
    x, eps = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    for t in (int(js.timesteps[0]), int(js.timesteps[-1])):   # incl. t - Δ < 0
        got = sched.ddim_step(ps, _t(eps), t, _t(x))
        want = jsched.ddim_step(js, jnp.asarray(eps), jnp.int32(t), jnp.asarray(x))
        assert _maxdiff(got, want) <= PRIM_TOL


def test_random_init_matches_jax_names_and_shapes(jparams):
    np_tree = jax.tree.map(np.asarray, jparams)
    for init, entries, tree, cfg in (
            (ck.init_unet, ck.unet_entries, np_tree["unet"], TINY.unet),
            (ck.init_text_encoder, ck.text_encoder_entries, np_tree["text"], TINY.text),
            (ck.init_vae, ck.vae_entries, np_tree["vae"], TINY.vae)):
        sd = init(cfg, 0, "cpu")
        want = ck.from_jax_params(tree, entries(cfg))
        assert sd.keys() == want.keys()
        assert all(sd[k].shape == want[k].shape for k in sd)
        ck.check_state_dict(sd, init(cfg, None, "meta"))
        # The JAX scheme: zero biases, unit norm scales, |w| ≤ 1/√fan_in.
        w = sd["conv_in.weight"] if "conv_in.weight" in sd else None
        if w is not None:
            assert float(w.abs().max()) <= (w.shape[1] * 9) ** -0.5
            assert float(sd["conv_in.bias"].abs().max()) == 0.0
