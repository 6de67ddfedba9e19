"""The arithmetic of K1 and K3 at d = 40 on the tensor cores, on the CPU.

``flash_d40_kernel`` (``p2p_tpu_torch/csrc/flash_attn.cu``) takes both
products of every 64-key step in 3xTF32 into a fresh accumulator added in
f32, runs its online softmax in base 2 on scores pre-scaled by
``scale·log2(e)``, and converts K3's row max back to natural units. The
kernel runs only on the card, where ``chip_smoke.py`` holds it within 1e-5
of the plain version; here its plain emulation
(``p2p_tpu_torch.kernels.tf32.flash_d40``) is held against the plain
version, against float64, and against the JAX package's Pallas flash kernel
with residuals under the interpreter, on numpy-seeded inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import tf32  # noqa: E402

D = 40
SCALE = D ** -0.5


def _qkv(seed, b, h, sq, sk):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, n, D).astype(np.float32))
            for n in (sq, sk, sk)]


def _exact(q, k, v):
    """``(out, l, m)`` in float64."""
    s = q.double() @ k.double().transpose(-1, -2) * SCALE
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    return (p @ v.double()) / l[..., None], l, m


def _rel(got, want) -> float:
    """max|Δ| relative to the largest magnitude of ``want``."""
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("sq,sk", [(4096, 4096), (300, 70)])
def test_d40_emulation_matches_plain_and_float64(sq, sk):
    """``out``, ``l`` and ``m`` of the emulated kernel and of the plain f32
    version are each within 1e-6 of float64, relative to the largest
    magnitude, so the two agree within the sum of their f32 errors (2e-6).
    (1, 1, 4096, 40) is the path's sequence length; Sq = 300 with Sk = 70
    leaves a ragged last step and Sq ≠ Sk."""
    q, k, v = _qkv(0, 1, 1, sq, sk)
    got = tf32.flash_d40(q, k, v, SCALE)
    plain = K.flash_attention_residuals_plain(q, k, v, SCALE)
    exact = _exact(q, k, v)
    for name, g, p, e in zip(("out", "l", "m"), got, plain, exact):
        assert g.shape == p.shape and g.dtype == torch.float32, name
        assert _rel(g, e) <= 1e-6, (name, _rel(g, e))
        assert _rel(p, e) <= 1e-6, (name, _rel(p, e))
        assert _rel(g, p) <= 2e-6, (name, _rel(g, p))


def test_d40_emulation_matches_pallas_interpret():
    """The emulated kernel against the JAX package's flash kernel with
    residuals, ``(out, l, m)``, at (1, 2, 512, 40) with 256-row blocks, as
    ``tests/test_torch_flash_grad.py`` holds the plain version."""
    q, k, v = _qkv(4, 1, 2, 512, 512)
    with force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jnn.flash_attention_residuals(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            SCALE, 256)]
    got = tf32.flash_d40(q, k, v, SCALE)
    for name, g, w in zip(("out", "l", "m"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


def test_d40_one_tf32_pass_fails_the_card_tolerance():
    """With one TF32 product per product the same blockwise kernel is off by
    more than ``chip_smoke.py``'s 1e-5 in every output, and 3xTF32 is well
    inside it, so the check on the card tells the two apart."""
    q, k, v = _qkv(1, 1, 1, 1024, 1024)
    plain = K.flash_attention_residuals_plain(q, k, v, SCALE)
    three = tf32.flash_d40(q, k, v, SCALE, tf32.mm_3xtf32)
    one = tf32.flash_d40(q, k, v, SCALE, tf32.mm_1xtf32)
    for name, g3, g1, p in zip(("out", "l", "m"), three, one, plain):
        assert _rel(g3, p) <= 2e-6, name
        assert _rel(g1, p) > 1e-5, (name, _rel(g1, p))


def test_d40_emulation_residuals_are_in_natural_units():
    """``m`` is the row max of ``q·kᵀ·scale`` and ``l`` sums ``exp(s − m)``
    (the convention K4 takes), not their base-2 forms: the base-2 max
    differs by a factor log2(e), and ``l·exp(m)`` is the softmax
    denominator."""
    q, k, v = _qkv(2, 1, 2, 256, 256)
    _, l, m = tf32.flash_d40(q, k, v, SCALE)
    _, l_ex, m_ex = _exact(q, k, v)
    assert _rel(m, m_ex) <= 1e-6
    assert _rel(m, m_ex * np.log2(np.e)) > 0.1
    denom = torch.exp(q.double() @ k.double().transpose(-1, -2) * SCALE).sum(-1)
    assert _rel(l.double() * torch.exp(m.double()), denom) <= 1e-6


@pytest.mark.parametrize("step", [64, 32])
def test_d40_emulation_does_not_depend_on_the_step_beyond_f32(step):
    """The online softmax's result does not depend on how the keys are cut
    into steps, beyond f32 rounding: a ragged 4100-key sequence in steps of
    64 or 32 against one step over all keys."""
    q, k, v = _qkv(3, 1, 1, 128, 4100)
    whole = tf32.flash_d40(q, k, v, SCALE, step=4100)
    for name, g, w in zip(("out", "l", "m"), tf32.flash_d40(q, k, v, SCALE, step=step),
                          whole):
        assert _rel(g, w) <= 2e-6, name
