"""The arithmetic of the port's tensor-core kernels, on the CPU.

K1 at d = 512 and both passes of K4 take every product on the tensor cores
in 3xTF32 (``p2p_tpu_torch/csrc/mma_tf32.cuh``), and K1 at d = 512 splits
the keys among blocks and merges their partial outputs. The CUDA kernels run
only on the card (``chip_smoke.py`` holds them against their plain versions
there); here the plain emulation of their arithmetic
(``p2p_tpu_torch/kernels/tf32.py``) and the plain version of the merge are
held against the plain f32 attention, against float64, and against the JAX
package's Pallas flash kernel with residuals under the interpreter.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import tf32  # noqa: E402
from p2p_tpu_torch.kernels.flash import key_splits, merge_partials  # noqa: E402


def _arrays(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(n)]


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, nearest with ties away from zero, in
    float64 arithmetic (normal f32 values)."""
    x = x.astype(np.float64)
    ulp = np.exp2(np.frexp(x)[1] - 11.0)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


# ------------------------------------------------------------ rounding

def test_tf32_round_is_nearest_ties_away():
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * np.exp2(rng.randint(-30, 30, 20000))).astype(np.float32)
    # Exact half-way points of both signs, and the f32 values just below.
    j, e = rng.randint(0, 1024, 200), rng.randint(-8, 8, 200)
    ties = ((1 + j * 2.0 ** -10 + 2.0 ** -11) * np.exp2(e)).astype(np.float32)
    x = np.concatenate([x, ties, -ties, np.nextafter(ties, np.float32(0))])
    got = tf32.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), _tf32_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()
    # Half-way between 1 and 1 + 2^-10 rounds away from zero.
    t = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11], dtype=torch.float32)
    assert tf32.tf32_round(t).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9]


def test_tf32_round_keeps_specials_and_carries_into_the_exponent():
    t = torch.tensor([0.0, -0.0, math.inf, -math.inf, 2 - 2 ** -23], dtype=torch.float32)
    got = tf32.tf32_round(t)
    assert got[:4].tolist() == [0.0, -0.0, math.inf, -math.inf]
    assert got[4].item() == 2.0
    assert torch.isnan(tf32.tf32_round(torch.tensor([math.nan]))).all()
    with pytest.raises(ValueError):
        tf32.tf32_round(torch.zeros(2, dtype=torch.float64))


def test_split_recovers_f32():
    (x,) = _arrays(1, 1, (4096,))
    hi, lo = tf32.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi + lo carries 22 of f32's 24 significant bits.
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0 ** -21


# ----------------------------------------------------------- products

@pytest.mark.parametrize("d", [512, 40])
def test_3xtf32_attention_matches_plain_f32(d):
    """Attention with both products in 3xTF32 stays within 1e-6 of the plain
    f32 version (the tensor-core kernels' tolerance on the card is 1e-5);
    one TF32 pass does not."""
    q, k, v = _arrays(2, 3, (1, 1, 1024, d))
    scale = d ** -0.5
    plain = K.flash_attention_plain(q, k, v, scale)
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) * scale, -1) @ v.double()
    three = tf32.attention(q, k, v, scale, tf32.mm_3xtf32)
    one = tf32.attention(q, k, v, scale, tf32.mm_1xtf32)
    assert (three - plain).abs().max() <= 1e-6
    assert (three.double() - exact).abs().max() <= 1e-6
    assert (one - plain).abs().max() > 1e-5
    assert (tf32.attention(q, k, v, scale, torch.matmul) - plain).abs().max() <= 1e-6


def _backward(q, k, v, do, di, scale, mm):
    """K4's products, each taken by ``mm``: ``(dq, dk, dv)`` of softmax
    attention given the output gradient ``do`` and ``di = Σ o·do``."""
    p = torch.softmax(mm(q, k.transpose(-1, -2)) * scale, dim=-1)
    ds = p * (mm(do, v.transpose(-1, -2)) - di[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2).contiguous(), q) * scale,
            mm(p.transpose(-1, -2).contiguous(), do))


def test_3xtf32_backward_meets_the_card_tolerance_and_1xtf32_does_not():
    """``chip_smoke.py`` holds K4 within 1e-5 of the plain version's largest
    gradient: the 3xTF32 products are well inside that, one TF32 pass is
    not, so the check on the card tells the two apart."""
    d = 40
    q, k, v, do = _arrays(7, 4, (1, 2, 512, d))
    scale = d ** -0.5
    o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
    plain = K.flash_attention_bwd_plain(q, k, v, o, do, l, m, scale)
    di = (o * do).sum(dim=-1)
    for name, mm, lo, hi in (("3xTF32", tf32.mm_3xtf32, 0.0, 4e-6),
                             ("1xTF32", tf32.mm_1xtf32, 1e-5, math.inf)):
        got = _backward(q, k, v, do, di, scale, mm)
        for g, w in zip(got, plain):
            rel = ((g - w).abs().max() / w.abs().max()).item()
            assert lo < rel <= hi, (name, rel)


def test_3xtf32_product_is_f32_accurate():
    a, b = _arrays(3, 2, (64, 512))
    want = a.double() @ b.double().T
    f32_err = (a @ b.T - want).abs().max()
    assert (tf32.mm_3xtf32(a, b.T) - want).abs().max() <= 4 * f32_err
    assert (tf32.mm_1xtf32(a, b.T) - want).abs().max() > 100 * f32_err


# ------------------------------------------------------ key-split merge

def _merge_halves(q, k, v, scale, cut):
    parts = [K.flash_attention_residuals_plain(q, k[..., sl, :], v[..., sl, :], scale)
             for sl in (slice(0, cut), slice(cut, None))]
    # The kernel keeps each split's output unnormalized.
    return merge_partials([o * l[..., None] for o, l, _ in parts],
                          [l for _, l, _ in parts], [m for _, _, m in parts])


@pytest.mark.parametrize("sq,sk,cut", [(256, 512, 256), (300, 70, 64)])
def test_merged_key_halves_equal_the_whole(sq, sk, cut):
    d = 512
    (q,) = _arrays(4, 1, (1, 1, sq, d))
    k, v = _arrays(5, 2, (1, 1, sk, d))
    scale = d ** -0.5
    got = _merge_halves(q, k, v, scale, cut)
    want = K.flash_attention_residuals_plain(q, k, v, scale)
    for name, g, w in zip(("out", "l", "m"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= 2e-6 * max(1.0, w.abs().max().item()), name


def test_merged_key_halves_match_pallas_interpret():
    """The merge against the JAX package's flash kernel with residuals,
    ``(out, l, m)``, at the VAE head dim (512), 2x2 blocks."""
    d = 512
    q, k, v = _arrays(6, 3, (1, 1, 512, d))
    scale = d ** -0.5
    with force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jnn.flash_attention_residuals(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            scale, 256)]
    got = _merge_halves(q, k, v, scale, 192)
    for name, g, w in zip(("out", "l", "m"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


def test_key_splits():
    sms = 132
    # (1, 1, 4096, 512): 64 query tiles; two splits make 128 blocks, one
    # wave, where four would take two waves of the same total work.
    assert key_splits(64, 64, sms) == 2
    # (2, 1, 4096, 512): 128 blocks fill one wave unsplit.
    assert key_splits(128, 64, sms) == 1
    # Enough query tiles: no split, no merge.
    assert key_splits(132, 64, sms) == 1 and key_splits(512, 64, sms) == 1
    # Never more splits than key tiles, never fewer than one.
    assert key_splits(5, 2, sms) == 2 and key_splits(1, 1, sms) == 1
    for blocks in range(1, sms):
        n = key_splits(blocks, 64, sms)
        waves = math.ceil(blocks * n / sms) / n
        assert 1 <= n <= 16
        assert all(waves <= math.ceil(blocks * m / sms) / m for m in range(1, 17))


def test_d512_wrappers_on_cpu_run_plain_and_count_no_merge():
    q, k, v = _arrays(8, 3, (1, 1, 128, 512))
    K.reset_launch_counts()
    out = K.flash_attention(q, k, v, 512 ** -0.5)
    res = K.flash_attention_residuals(q, k, v, 512 ** -0.5)
    assert torch.equal(out, K.flash_attention_plain(q, k, v, 512 ** -0.5))
    for got, want in zip(res, K.flash_attention_residuals_plain(q, k, v, 512 ** -0.5)):
        assert torch.equal(got, want)
    assert K.merge_launches() == 0
    assert set(K.launch_counts().values()) == {0}
