"""Where the bf16 backward rounds: the cotangent each primitive of the port
hands back, against the JAX package's, on the CPU.

The JAX side is ``jax.jit`` of ``jax.vjp`` of the JAX package's primitive,
as XLA compiles it inside the null-text inversion's program; the port's is
autograd through its primitive. Inputs and the upstream cotangent are
numpy-seeded bf16 values, the same on both sides. Every cotangent leaves its
primitive in bf16 on both sides. Where the JAX program transposes its bf16
primitives one by one (silu, gelu, and the probabilities' product with the
values, whose cotangent XLA leaves in f32 before the f32 softmax reads it),
the port's backward follows that chain (``models/nn.py``: ``_SiluLowp``,
``_GeluLowp``, ``_ProbsValueLowp``) and the cotangents agree within one
bf16 ulp of each element; so do linear and the residual add.

The norms' backward sums its cotangents over the broadcast statistics in
bf16, the running sum rounded at every add, in the windows of XLA's CPU
tree-reduction rewrite (read from the compiled HLO below); the port sums
them the same way (``kernels.reduce``), bit for bit with ``jax.lax.reduce``
at the U-Net's shapes. The rest of a norm's backward, the f32 chains that
XLA fuses around those sums, the port follows as the HLO of
``jax.jit(jax.vjp(nn.layer_norm / nn.group_norm, x)[1])`` computes them
(``models/nn.py``: ``_LayerNormLowp``, ``_GroupNormLowp``), so a norm's
cotangents agree with JAX's within one bf16 ulp of each element, and stand
as far from the f32 cotangent as JAX's do. At the U-Net's flash sites the JAX
program on the CPU takes ``jax.nn.dot_product_attention`` while the port
runs K3/K4, held to the Pallas kernel's gradient in
``tests/test_torch_bf16_inversion.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch.kernels.reduce import broadcast_sum, window_sum  # noqa: E402
from p2p_tpu_torch.models import nn as pnn  # noqa: E402

JB, TB = jnp.bfloat16, torch.bfloat16
C = 64
SCALE = 16 ** -0.5


def _norm_params(seed):
    rng = np.random.RandomState(seed)
    return ((1.0 + 0.3 * rng.randn(C)).astype(np.float32),
            (0.2 * rng.randn(C)).astype(np.float32))


W_LN, B_LN = _norm_params(1)
W_LIN = (np.random.RandomState(2).randn(C, 96) / 8).astype(np.float32)
B_LIN = (0.1 * np.random.RandomState(3).randn(96)).astype(np.float32)


def _jp():
    return {"scale": jnp.asarray(W_LN), "bias": jnp.asarray(B_LN)}


def _tp():
    return torch.from_numpy(W_LN), torch.from_numpy(B_LN)


# name: (JAX primitive, port primitive, input shapes); spatial tensors NHWC
# on both sides (the port's NCHW group norm is transposed around).
PRIMITIVES = {
    "silu": (jnn.silu, pnn.silu, [(2, 77, C)]),
    "gelu": (jnn.gelu, pnn.gelu, [(2, 77, C)]),
    "geglu": (lambda v, g: v * jnn.gelu(g), lambda v, g: v * pnn.gelu(g),
              [(2, 77, C)] * 2),
    "linear": (lambda x: jnn.linear({"kernel": jnp.asarray(W_LIN, JB),
                                     "bias": jnp.asarray(B_LIN)}, x),
               lambda x: pnn.linear(x, torch.from_numpy(W_LIN.T.copy()).to(TB),
                                    torch.from_numpy(B_LIN).to(TB)),
               [(2, 77, C)]),
    "add": (lambda x, y: x + y, pnn.add, [(2, 77, C)] * 2),
    "cross_attention": (lambda q, k, v: jnn.fused_attention(q, k, v, SCALE),
                        lambda q, k, v: pnn.fused_attention(q, k, v, SCALE),
                        [(2, 2, 64, 16), (2, 2, 77, 16), (2, 2, 77, 16)]),
    "layer_norm": (lambda x: jnn.layer_norm(_jp(), x),
                   lambda x: pnn.layer_norm(x, *_tp()), [(2, 77, C)]),
    "add_layer_norm": (lambda x, y: jnn.layer_norm(_jp(), x + y),
                       lambda x, y: pnn.layer_norm(pnn.add(x, y), *_tp()),
                       [(2, 77, C)] * 2),
    "group_norm": (lambda x: jnn.group_norm(_jp(), x, 8),
                   lambda x: pnn.group_norm(x.permute(0, 3, 1, 2), *_tp(), 8)
                   .permute(0, 2, 3, 1), [(2, 8, 8, C)]),
    "flash_site": (lambda q, k, v: jnn.fused_attention(q, k, v, SCALE),
                   lambda q, k, v: pnn.fused_attention(q, k, v, SCALE),
                   [(1, 2, 2304, 16)] * 3),
}
MATCHED = ("silu", "gelu", "geglu", "linear", "add", "cross_attention")
NORMS = ("layer_norm", "add_layer_norm", "group_norm")


def _taps(name, seed=0):
    """``[(jax bf16, port bf16, f32 reference)]`` cotangents of each input
    of primitive ``name`` (f64 numpy arrays), after asserting that both
    sides hand them back in bf16; the reference is the JAX primitive's vjp
    in f32 on the same (bf16-valued) inputs and cotangent."""
    jf, pf, shapes = PRIMITIVES[name]
    rng = np.random.RandomState(seed)
    xs = [jnp.asarray(rng.randn(*s), JB) for s in shapes]
    out_shape = jax.eval_shape(jf, *xs).shape
    g = jnp.asarray(rng.randn(*out_shape), JB)

    def vjp(*a):
        return jax.vjp(jf, *a[:-1])[1](a[-1])

    j16 = jax.jit(vjp)(*xs, g)
    j32 = jax.jit(vjp)(*[x.astype(jnp.float32) for x in xs], g.astype(jnp.float32))
    tx = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(TB).requires_grad_(True)
          for x in xs]
    p16 = torch.autograd.grad(pf(*tx), tx, torch.from_numpy(
        np.asarray(g.astype(jnp.float32))).to(TB))
    assert all(a.dtype == JB for a in j16), name
    assert all(a.dtype == TB for a in p16), name
    return [(np.asarray(a.astype(jnp.float32), np.float64), b.double().numpy(),
             np.asarray(r, np.float64)) for a, b, r in zip(j16, p16, j32)]


def _ulps(a, b):
    """Largest |a − b| in bf16 ulps of the larger magnitude of each pair."""
    big = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return float(np.max(np.abs(a - b) / ulp))


def _rms(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


@pytest.mark.parametrize("name", MATCHED)
def test_cotangent_matches_jax_within_one_ulp(name):
    for j, p, _ in _taps(name):
        assert _ulps(p, j) <= 1.0, (name, _ulps(p, j))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NORMS)
def test_norm_cotangent_matches_jax_within_one_ulp(name, seed):
    """Every element of a bf16 norm's input cotangent within one bf16 ulp
    of the JAX program's: the port's backward (``_LayerNormLowp``,
    ``_GroupNormLowp``) rounds where XLA's compiled backward rounds."""
    for j, p, _ in _taps(name, seed):
        assert _ulps(p, j) <= 1.0, (name, seed, _ulps(p, j))


@pytest.mark.parametrize("name", NORMS)
def test_norm_cotangent_bf16_and_as_far_from_f32_as_jax(name):
    """The norms' cotangents: bf16 on both sides, within a few bf16
    roundings of JAX's (1e-2 of the largest magnitude), and as far from the
    f32 cotangent as JAX's (RMS, within a tenth)."""
    for j, p, ref in _taps(name):
        top = np.abs(ref).max()
        print(f"{name}: port-vs-JAX {np.abs(p - j).max() / top:.3g} max; RMS from f32 "
              f"port {_rms(p, ref):.3g}, JAX {_rms(j, ref):.3g}")
        assert np.abs(p - j).max() <= 1e-2 * top
        assert 0.9 <= _rms(p, ref) / _rms(j, ref) <= 1.1


# (extents in the JAX package's order, reduced dimensions): the sums of the
# norms' backward at TINY-48 and SD shapes: a group norm's mean over
# (pixels, channels of a group) and its inverse deviation and shift over the
# pixels, a layer norm's statistics over the channels; windows of 32 with
# padding, two and three stages, and single stages.
REDUCTIONS = [((2, 48, 48, 8, 4), (1, 2, 4)), ((2, 48, 48, 8, 4), (1, 2)),
              ((2, 24, 24, 8, 8), (1, 2, 4)), ((1, 64, 64, 32, 10), (1, 2, 4)),
              ((1, 96, 96, 32, 10), (1, 2)), ((1, 8, 8, 32, 40), (1, 2, 4)),
              ((1, 4096, 320), (2,)), ((2, 77, 1280), (2,)), ((2, 1100, 4), (1,)),
              # SD-2.1 768-v's gradient: its 96² and 48² group norms and a
              # layer norm over 320 channels at 9216 tokens.
              ((1, 96, 96, 32, 10), (1, 2, 4)), ((1, 48, 48, 32, 20), (1, 2, 4)),
              ((1, 48, 48, 32, 20), (1, 2)), ((1, 9216, 320), (2,))]


@pytest.mark.parametrize("shape,dims", REDUCTIONS, ids=lambda v: "x".join(map(str, v)))
def test_window_sum_equals_xla_bf16_reduce(shape, dims):
    """The port's sum is bitwise XLA's compiled bf16 reduction."""
    x = jnp.asarray(np.random.RandomState(4).randn(*shape), JB)
    want = jax.jit(lambda x: jax.lax.reduce(x, JB(0), jax.lax.add, dims))(x)
    got = window_sum(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(TB), dims)
    assert got.dtype == TB
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape),
                                  np.asarray(want.astype(jnp.float32)))


def test_group_norm_broadcast_cotangent_equals_jax():
    """A statistic of the port's NCHW group, broadcast over its pixels,
    takes back the cotangent JAX's NHWC broadcast does, bit for bit."""
    rng = np.random.RandomState(5)
    c = jnp.asarray(rng.randn(2, 48, 48, 8, 4), JB)                 # (n, H, W, g, c/g)
    a = jnp.zeros((2, 1, 1, 8, 4), JB)
    want = jax.jit(lambda a, c: jax.vjp(lambda a: jnp.broadcast_to(a, c.shape), a)[1](c))(a, c)[0]
    ct = torch.from_numpy(np.asarray(c.astype(jnp.float32))).to(TB).permute(0, 3, 4, 1, 2)
    got = broadcast_sum(ct, (2, 8, 4, 1, 1), [0, 3, 4, 1, 2])        # (n, g, c/g, 1, 1)
    np.testing.assert_array_equal(got.float().permute(0, 3, 4, 1, 2).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_flash_site_cotangents_bf16_and_close():
    """At a flash site (S ≥ 2048) the JAX program on the CPU takes XLA's
    ``dot_product_attention``; the port's K3/K4 plain versions follow the
    Pallas kernel. Both hand back bf16 cotangents within the bf16 kernels'
    bar (1e-2 of the largest magnitude) of each other."""
    for j, p, ref in _taps("flash_site"):
        assert np.abs(p - j).max() <= 1e-2 * np.abs(ref).max()


def test_jax_norm_backward_reduces_with_a_bf16_accumulator():
    """Why the norms' sums are windowed bf16 sums: the JAX program's
    compiled backward of a bf16 group norm sums its cotangents in reducers
    that round the running sum to bf16 after every add (XLA's CPU
    backend), where autograd's sums accumulate in f32 and round once."""
    x = jnp.ones((1, 8, 8, C), JB)
    hlo = jax.jit(lambda x, c: jax.vjp(lambda x: jnn.group_norm(_jp(), x, 8), x)[1](c)
                  ).lower(x, x).compile().as_text()
    reducers = [blk for blk in hlo.split("\n\n") if "reduce_sum" in blk and "add(" in blk
                and "-> f32[] {" in blk]
    assert any("bf16[] convert(" in blk for blk in reducers)
