"""The port's bf16 modules against the JAX package's bf16, on the CPU.

bf16 is the JAX package's production dtype. The port rounds where the JAX
package's compiled program rounds (``p2p_tpu_torch/models/nn.py``), so its
primitives agree with the JAX package's bit for bit here, held to one bf16
ulp of the output:

- ``group_norm`` / ``layer_norm`` with scales and biases away from 1 and 0
  (the JAX package's own tests use ones and zeros, which hide which of the
  f32 or the bf16 scale each path reads), at the JAX suite's constant-input
  and large-mean cases; the layer norm also on a residual sum made by
  ``nn.add``, whose mean the JAX program takes before rounding;
- the activations, linear and convolution with bias, the text encoder;
- the compute-dtype weights (``Pipeline.weights``).

The kernels' plain versions in bf16 against the JAX package's Pallas
kernels under the interpreter (K1: the library flash kernel at a multiblock
shape; K2: ``edit_attention`` for Replace, Refine and Reweight at cross and
self geometries), and the bf16 kernels' arithmetic (``kernels.bf16``)
against float64 and the Pallas kernel: all within 1e-2 of the largest
magnitude (the bar ``chip_smoke.py`` holds the CUDA kernels to); the
measured values are in the asserts' messages and PERF.md.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.controllers.kernel_spec import EditSpec as JEditSpec  # noqa: E402
from p2p_tpu.engine import sampler as jsampler  # noqa: E402
from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.kernels.fused_edit import edit_attention as j_edit_attention  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.engine.sampler import encode_prompts, random_pipeline  # noqa: E402
from p2p_tpu_torch.kernels import bf16 as kbf16  # noqa: E402
from p2p_tpu_torch.kernels.flash import check_operands  # noqa: E402
from p2p_tpu_torch.models import checkpoint as ck  # noqa: E402
from p2p_tpu_torch.models import nn as pnn  # noqa: E402
from p2p_tpu_torch.models.config import TINY  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer  # noqa: E402

from tests.test_torch_fused_edit_tc import CASES, _exact  # noqa: E402
from tests.test_torch_pipeline import make_pipes  # noqa: E402

JB, TB = jnp.bfloat16, torch.bfloat16
# The kernels' plain versions and the bf16 kernels' arithmetic against the
# Pallas kernels and float64, relative to the largest magnitude: P and the
# output round to bf16 (2^-8 relative) in other places on the two sides.
KERNEL_TOL = 1e-2


def _ulps(got: torch.Tensor, want) -> float:
    """Largest |got − want| in bf16 ulps of want (both bf16 values)."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    g = got.double().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    return float(np.max(np.abs(g - w) / ulp))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _norm_params(c, seed):
    rng = np.random.RandomState(seed)
    return ((1.0 + 0.3 * rng.randn(c)).astype(np.float32),
            (0.2 * rng.randn(c)).astype(np.float32))


# (mean, std) of the JAX suite's bf16 norm tests (tests/test_nn.py).
STATS = [(0, 1), (20, 1), (100, 0.1), (500, 0.5), (100, 10), (-50, 2)]


@pytest.mark.parametrize("mean,std", STATS)
def test_group_norm_bf16_matches_jax(mean, std):
    x = (np.random.RandomState(0).randn(2, 8, 8, 16) * std + mean).astype(np.float32)
    scale, bias = _norm_params(16, 1)
    want = jax.jit(lambda p, x: jnn.group_norm(p, x, 4))(
        {"scale": scale, "bias": bias}, jnp.asarray(x, JB))
    got = pnn.group_norm(torch.from_numpy(x).to(TB).permute(0, 3, 1, 2),
                         torch.from_numpy(scale), torch.from_numpy(bias), 4)
    assert got.dtype == TB
    assert _ulps(got.permute(0, 2, 3, 1), want) <= 1.0


@pytest.mark.parametrize("mean,std", STATS)
def test_layer_norm_bf16_matches_jax(mean, std):
    x = (np.random.RandomState(2).randn(2, 9, 32) * std + mean).astype(np.float32)
    scale, bias = _norm_params(32, 3)
    want = jax.jit(lambda p, x: jnn.layer_norm(p, x))(
        {"scale": scale, "bias": bias}, jnp.asarray(x, JB))
    got = pnn.layer_norm(torch.from_numpy(x).to(TB), torch.from_numpy(scale),
                         torch.from_numpy(bias))
    assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_norm_bf16_constant_input_is_bias(norm):
    scale, bias = _norm_params(8, 4)
    x = np.full((1, 4, 4, 8), 13.3, np.float32)
    p = {"scale": scale, "bias": bias}
    if norm == "group":
        want = jax.jit(lambda p, x: jnn.group_norm(p, x, 4))(p, jnp.asarray(x, JB))
        got = pnn.group_norm(torch.from_numpy(x).to(TB).permute(0, 3, 1, 2),
                             torch.from_numpy(scale), torch.from_numpy(bias), 4)
        got = got.permute(0, 2, 3, 1)
    else:
        want = jax.jit(lambda p, x: jnn.layer_norm(p, x))(p, jnp.asarray(x, JB))
        got = pnn.layer_norm(torch.from_numpy(x).to(TB), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    assert _ulps(got, want) <= 1.0
    np.testing.assert_allclose(got.float().numpy(), np.broadcast_to(bias, x.shape),
                               atol=1e-2)


def test_layer_norm_bf16_of_a_residual_sum_matches_jax():
    """The JAX program takes a layer norm's mean of the residual sum before
    it is rounded; ``nn.add`` keeps that sum for the port's layer norm."""
    rng = np.random.RandomState(5)
    a, b = (rng.randn(2, 16, 32).astype(np.float32) * 3 for _ in range(2))
    scale, bias = _norm_params(32, 6)
    want = jax.jit(lambda p, a, b: jnn.layer_norm(p, a + b))(
        {"scale": scale, "bias": bias}, jnp.asarray(a, JB), jnp.asarray(b, JB))
    s = pnn.add(torch.from_numpy(a).to(TB), torch.from_numpy(b).to(TB))
    assert torch.equal(s, torch.from_numpy(a).to(TB) + torch.from_numpy(b).to(TB))
    got = pnn.layer_norm(s, torch.from_numpy(scale), torch.from_numpy(bias))
    assert _ulps(got, want) <= 1.0


def test_norms_f32_unchanged():
    """The f32 branches are PyTorch's own norms, as before bf16."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 8, 6, 6).astype(np.float32) * 3 + 7)
    w, b = (torch.from_numpy(t) for t in _norm_params(8, 8))
    assert torch.equal(pnn.group_norm(x, w, b, 4),
                       torch.nn.functional.group_norm(x, 4, w, b, 1e-5))
    y = x.permute(0, 2, 3, 1).contiguous()
    assert torch.equal(pnn.layer_norm(y, w, b),
                       torch.nn.functional.layer_norm(y, (8,), w, b, 1e-5))
    assert not hasattr(pnn.add(x, x), "unrounded")


@pytest.mark.parametrize("name", ["silu", "gelu", "quick_gelu"])
def test_activations_bf16_match_jax(name):
    x = (np.random.RandomState(9).randn(4, 64, 32) * 3).astype(np.float32)
    want = jax.jit(getattr(jnn, name))(jnp.asarray(x, JB))
    got = getattr(pnn, name)(torch.from_numpy(x).to(TB))
    assert got.dtype == TB and _ulps(got, want) <= 1.0


def test_linear_and_conv_bf16_match_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    kern = (rng.randn(3, 3, 16, 8) / 12).astype(np.float32)
    lin = (rng.randn(16, 24) / 4).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    want = jax.jit(lambda p, x: jnn.conv2d(p, x))(
        {"kernel": kern, "bias": bias[:8]}, jnp.asarray(x, JB))
    got = pnn.conv2d(torch.from_numpy(x).to(TB).permute(0, 3, 1, 2),
                     torch.from_numpy(kern).permute(3, 2, 0, 1).to(TB),
                     torch.from_numpy(bias[:8]).to(TB))
    assert _ulps(got.permute(0, 2, 3, 1), want) <= 1.0
    want = jax.jit(lambda p, x: jnn.linear(p, x))(
        {"kernel": lin, "bias": bias}, jnp.asarray(x, JB))
    got = pnn.linear(torch.from_numpy(x).to(TB), torch.from_numpy(lin.T.copy()).to(TB),
                     torch.from_numpy(bias).to(TB))
    assert _ulps(got, want) <= 1.0


def test_pipeline_weights_cast_once_norms_and_vae_stay_f32():
    pipe = random_pipeline(TINY, HashWordTokenizer(model_max_length=16), "cpu")
    unet, text = pipe.weights(TB)
    assert pipe.weights(TB)[0] is unet                      # cached
    assert pipe.weights(torch.float32) == (pipe.unet, pipe.text_encoder)
    for sd, entries in ((unet, ck.unet_entries(pipe.config.unet)),
                        (text, ck.text_encoder_entries(pipe.config.text))):
        norms = ck.norm_names(entries)
        assert norms and len(norms) % 2 == 0
        for name, t in sd.items():
            assert t.dtype == (torch.float32 if name in norms else TB), name
    assert "text_model.embeddings.token_embedding.weight" not in ck.norm_names(
        ck.text_encoder_entries(pipe.config.text))
    assert all(t.dtype == torch.float32 for t in pipe.vae.values())


def test_text_encoder_bf16_matches_jax():
    jpipe, pipe = make_pipes()
    prompts = ["a cat riding a bike", "a dog riding a bike", ""]
    want = jsampler.encode_prompts(jpipe, prompts, dtype=JB)
    got = encode_prompts(pipe, prompts, TB)
    assert got.dtype == TB
    assert _ulps(got, want) <= 1.0


def test_kernel_operands_bf16_only_besides_f32():
    t = torch.zeros(1, 1, 16, 40, dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        check_operands("flash_attention", (("q", t),), (40,), torch.float16)
    with pytest.raises(ValueError, match="must be contiguous"):
        check_operands("flash_attention", (("q", t),), (40,), torch.bfloat16)


def _flash_ref(q, k, v, scale):
    """The JAX package's materialized attention in bf16 (P rounded to
    v's dtype): what ``flash_attention_plain`` computes."""
    probs = jnn.attention_probs(q, k, scale).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v, preferred_element_type=jnp.float32)


def test_flash_plain_bf16_matches_pallas_multiblock():
    """K1's plain version and the bf16 kernel's arithmetic in bf16 against
    the Pallas flash kernel under the interpreter at S = 512 in blocks of
    256 (the online softmax over two key blocks), d = 40."""
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(1, 2, 512, 40).astype(np.float32) for _ in range(3))
    scale = 40 ** -0.5
    jq, jk, jv = (jnp.asarray(a, JB) for a in (q, k, v))
    with force_tpu_interpret_mode():
        want = jnn.flash_attention_tpu(jq, jk, jv, scale, 256)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(TB) for a in (q, k, v))
    plain = K.flash_attention_plain(tq, tk, tv, scale)
    assert plain.dtype == TB
    err = _rel(plain.float().numpy(), want)
    assert err <= KERNEL_TOL, err
    emulated = kbf16.flash(tq, tk, tv, scale).to(TB)
    assert _rel(emulated.float().numpy(), want) <= KERNEL_TOL
    # The plain version rounds as the JAX package's materialized path does.
    ref = np.asarray(_flash_ref(jq, jk, jv, scale).astype(JB).astype(jnp.float32))
    assert _rel(plain.float().numpy(), ref) <= 1e-2
    exact = torch.softmax(torch.from_numpy(q).double() @ torch.from_numpy(k).double()
                          .transpose(-1, -2) * scale, -1) @ torch.from_numpy(v).double()
    assert _rel(emulated.double().numpy(), exact.numpy()) <= KERNEL_TOL


def test_flash_plain_f32_unchanged_by_the_rounding():
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 64, 40).astype(np.float32))
               for _ in range(3))
    probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.2, dim=-1)
    assert torch.equal(K.flash_attention_plain(q, k, v, 0.2),
                       torch.einsum("bhqk,bhkd->bhqd", probs, v))


K2_CASES = ["tiny-replace", "tiny-refine", "tiny-reweight", "tiny-self-in-window",
            "tiny-self-after-window", "tiny-fractional-alpha", "sd-cross-d40",
            "sd-cross-d160", "sd-self-k256", "ragged-k100"]


@pytest.mark.parametrize("name", K2_CASES)
def test_edit_plain_and_folded_bf16_match_pallas(name):
    """K2 in bf16: the plain version (the edited P rounded to bf16 once, as
    the Pallas kernel rounds it) and the bf16 kernels' folded arithmetic
    (base P, own P and the folded values each rounded) against the Pallas
    kernel under the interpreter on the same bf16 inputs, and the folded
    arithmetic against float64."""
    q, k, v, scale, spec, ops = CASES[name][0]()
    q, k, v = (t.to(TB) for t in (q, k, v))
    want = j_edit_attention(
        *(jnp.asarray(t.float().numpy(), JB) for t in (q, k, v)), scale,
        JEditSpec(**dataclasses.asdict(spec)),
        {n: jnp.asarray(t.numpy()) for n, t in ops.items()}, interpret=True)
    assert want.dtype == JB
    want = np.asarray(want.astype(jnp.float32))
    plain = K.edit_attention_plain(q, k, v, scale, spec, ops)
    assert plain.dtype == TB
    err_plain = _rel(plain.float().numpy(), want)
    assert err_plain <= KERNEL_TOL, err_plain
    folded = kbf16.fused_edit_folded(q, k, v, scale, spec, ops)
    b_half = q.shape[0] // 2
    err_fold = _rel(folded[b_half + 1:].float().numpy(), want[b_half + 1:])
    assert err_fold <= KERNEL_TOL, err_fold
    exact = _exact(q.float(), k.float(), v.float(), scale, spec, ops)
    assert _rel(folded.double().numpy(), exact.numpy()) <= KERNEL_TOL
