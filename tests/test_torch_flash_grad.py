"""K3 and K4's plain versions, and the autograd Function that pairs them,
against the JAX package's Pallas flash kernels.

On the CPU the wrappers of ``p2p_tpu_torch.kernels`` run their plain
versions; here they are held against the Pallas TPU kernels themselves,
run by the Pallas interpreter under ``force_tpu_interpret_mode`` as
``tests/test_flash_pallas.py`` runs them, on the same numpy-seeded inputs.
The CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.models import nn as pnn  # noqa: E402


def _arrays(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def test_residuals_plain_matches_pallas_interpret():
    """K3: ``(out, l, m)`` at the U-Net 64² site's head dim, 2x2 blocks."""
    q, k, v = _arrays(4, 3, (1, 2, 512, 40))
    scale = 40 ** -0.5
    with force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jnn.flash_attention_residuals(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 256)]
    got = K.flash_attention_residuals_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale,
        chunk=192)
    # f32 on both sides; the kernel's online softmax reassociates the sums:
    # out and m agree to f32 rounding of O(1) values, l (a sum of up to 512
    # terms ≤ 1) to the same relative precision.
    for name, g, w in zip(("out", "l", "m"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


def test_flash_function_grad_matches_jax_pallas_interpret():
    """K3 + K4 through ``FlashAttentionFunction`` against ``jax.grad`` of the
    Pallas kernel at the tiling ``test_flash_pallas.py`` pins (forward
    blocks 1024, backward blocks 512); the loss ``Σ o·g`` with a random
    ``g`` checks dq, dk and dv."""
    q, k, v, g = _arrays(5, 4, (1, 2, 1024, 40))
    scale = 40 ** -0.5

    def loss(q, k, v):
        return jnp.sum(jnn.flash_attention_tpu(q, k, v, scale, 1024) * g)

    with force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = K.FlashAttentionFunction.apply(tq, tk, tv, scale)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    # f32 gradients summed over 1024 keys or queries in different orders.
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_bwd_plain_passes_match_materialized_autograd():
    """The two plain passes, chunked over queries with a ragged last chunk,
    against autograd of the materialized softmax attention (f64)."""
    q, do = _arrays(6, 2, (2, 1, 300, 40))
    k, v = _arrays(7, 2, (2, 1, 200, 40))
    scale = 0.2
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, l, m = K.flash_attention_residuals_plain(tq, tk, tv, scale)
    di = (out * tdo).sum(-1)
    dk, dv = K.flash_attention_bwd_dkv_plain(tq, tk, tv, tdo, l, m, di, scale, chunk=128)
    dq = K.flash_attention_bwd_dq_plain(tq, tk, tv, tdo, l, m, di, scale, chunk=128)
    xq, xk, xv = (t.double().requires_grad_(True) for t in (tq, tk, tv))
    ref = torch.softmax(xq @ xk.transpose(-1, -2) * scale, -1) @ xv
    want = torch.autograd.grad(ref, (xq, xk, xv), tdo.double())
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert (a.double() - w).abs().max() <= 1e-5 * w.abs().max(), name


def test_fused_attention_routes_to_function_only_under_grad():
    q, k, v = (torch.from_numpy(a) for a in _arrays(8, 3, (1, 2, 2048, 16)))
    K.reset_launch_counts()
    out = pnn.fused_attention(q, k, v, 0.25)
    assert out.grad_fn is None
    assert torch.equal(out, K.flash_attention_plain(q, k, v, 0.25))
    qg = q.clone().requires_grad_(True)
    out = pnn.fused_attention(qg, k, v, 0.25)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert pnn.fused_attention(qg, k, v, 0.25).grad_fn is None
    # Below the flash threshold the einsum path stays, grad or not.
    small = pnn.fused_attention(qg[:, :, :64], k[:, :, :64], v[:, :, :64], 0.25)
    assert type(small.grad_fn).__name__ != "FlashAttentionFunctionBackward"
    # On CPU tensors the plain versions run: no kernel launch is counted.
    assert set(K.launch_counts().values()) == {0}
