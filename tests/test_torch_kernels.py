"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``p2p_tpu_torch.kernels`` runs its plain PyTorch
version; here those plain versions are held against the Pallas kernels
themselves, run by the Pallas interpreter (K1 under
``force_tpu_interpret_mode`` as ``tests/test_flash_pallas.py`` runs it, K2
with ``interpret=True``), on the same numpy-seeded inputs. The CUDA kernels
are held against the same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.align.words import get_equalizer  # noqa: E402
from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.kernels.fused_edit import fused_site_attention as j_fused_site  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402
from p2p_tpu.models.config import TINY as J_TINY, unet_layout as j_unet_layout  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.controllers.base import Controller  # noqa: E402
from p2p_tpu_torch.controllers.edit import EditParams  # noqa: E402
from p2p_tpu_torch.controllers.kernel_spec import edit_operands, kernel_edit_spec  # noqa: E402
from p2p_tpu_torch.models.config import TINY, unet_layout  # noqa: E402

PROMPTS = ["a cat riding a bike", "the dog eating some pizza"]
STEPS = 3


def _qkv(seed, shape_q, shape_kv):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32))


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("shape,blk", [
    ((1, 2, 512, 40), 256),   # the U-Net 64² site's head dim, 2x2 blocks
    ((1, 1, 512, 512), 256),  # the VAE mid attention's head, reduced S
])
def test_flash_plain_matches_pallas_interpret(shape, blk):
    q, k, v = _qkv(11, shape, shape)
    scale = shape[-1] ** -0.5
    with force_tpu_interpret_mode():
        want = np.asarray(jnn.flash_attention_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, blk))
    got = K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale, chunk=192)
    # f32 on both sides; the kernel's online softmax reassociates the sums
    # the plain version takes in one pass: agreement to a few f32 ulps of
    # the O(1) outputs.
    assert np.abs(got.numpy() - want).max() <= 2e-5


def test_flash_wrapper_on_cpu_runs_plain_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, (2, 1, 64, 40), (2, 1, 64, 40)))
    K.reset_launch_counts()
    out = K.flash_attention(q, k, v, 0.2)
    assert torch.equal(out, K.flash_attention_plain(q, k, v, 0.2))
    assert K.launch_counts() == {"flash_attn": 0, "fused_edit": 0}


# ---------------------------------------------------------------- K2

def _jax_ctrl(mode, store=False):
    tok = JTok(model_max_length=J_TINY.text.max_length)
    kw = dict(tokenizer=tok, max_len=J_TINY.text.max_length,
              self_max_pixels=J_TINY.unet.sample_size ** 2, store=store)
    if mode == "replace":
        return jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, **kw)
    if mode == "refine":
        return jfactory.attention_refine(PROMPTS, STEPS, 0.8, 0.4, **kw)
    assert mode == "reweight"   # Reweight stacked on Replace
    base = jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, **kw)
    eq = get_equalizer(PROMPTS[1], ["dog"], [3.0], tok, mode="paired")
    return jfactory.attention_reweight(PROMPTS, STEPS, 0.8, 0.4, eq,
                                       base=base, **kw)


def _port_ctrl(jc) -> Controller:
    """The port's controller holding the JAX controller's exact parameters."""
    e = jc.edit

    def t(x, dtype=None):
        return None if x is None else torch.from_numpy(np.array(x)).to(dtype)

    edit = EditParams(
        cross_alpha=t(e.cross_alpha, torch.float32),
        mapper=t(e.mapper, torch.float32 if e.kind == "replace" else torch.int64),
        refine_alphas=t(e.refine_alphas, torch.float32),
        equalizer=t(e.equalizer, torch.float32),
        self_start=int(e.self_start), self_end=int(e.self_end),
        kind=e.kind, self_max_pixels=e.self_max_pixels)
    return Controller(edit=edit, store=jc.store)


def _site(cross, pixels):
    jl, pl = j_unet_layout(J_TINY.unet), unet_layout(TINY.unet)
    for jm, pm in zip(jl.metas, pl.metas):
        if jm.is_cross == cross and jm.pixels == pixels:
            return jm, pm
    raise AssertionError((cross, pixels))


def _edit_pair(mode, cross, pixels, step, seed=0, batch=4):
    jm, pm = _site(cross, pixels)
    d = jm.channels // jm.heads
    q, k, v = _qkv(seed, (batch, jm.heads, jm.pixels, d),
                   (batch, jm.heads, jm.key_len, d))
    scale = d ** -0.5
    jc = _jax_ctrl(mode)
    want = j_fused_site(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                        jc, jm, jnp.int32(step), interpret=True)
    got = K.fused_site_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale, _port_ctrl(jc),
                                 pm, step)
    assert want is not None and got is not None
    return np.asarray(want), got.numpy(), (q, k, v, scale)


# Both sides compute the same f32 formula; only the summation order of the
# q·kᵀ, base@M and probs@v products differs.
EDIT_TOL = 1e-5


@pytest.mark.parametrize("mode", ["replace", "refine", "reweight"])
@pytest.mark.parametrize("step", [0, 2])
def test_edit_plain_matches_pallas_interpret_cross(mode, step):
    want, got, _ = _edit_pair(mode, cross=True, pixels=256, step=step,
                              seed=len(mode) + step)
    assert np.abs(got - want).max() <= EDIT_TOL


@pytest.mark.parametrize("step", [0, 2])  # inside / outside the window [0, 1)
def test_edit_plain_matches_pallas_interpret_self(step):
    want, got, _ = _edit_pair("replace", cross=False, pixels=64, step=step,
                              seed=5 + step)
    assert np.abs(got - want).max() <= EDIT_TOL


def test_edit_uncond_and_base_rows_are_plain_attention():
    want, got, (q, k, v, scale) = _edit_pair("replace", cross=True,
                                             pixels=256, step=0, seed=3)
    plain = K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale).numpy()
    b_half = q.shape[0] // 2
    assert np.abs(got[:b_half + 1] - plain[:b_half + 1]).max() <= EDIT_TOL
    assert np.abs(want[:b_half + 1] - plain[:b_half + 1]).max() <= EDIT_TOL
    # ... and the edit row did change.
    assert np.abs(got[b_half + 1:] - plain[b_half + 1:]).max() > 1e-3


def test_fused_site_attention_declines_like_the_jax_side():
    jm, pm = _site(True, 256)
    pc = _port_ctrl(_jax_ctrl("replace"))
    q = torch.zeros(4, pm.heads, pm.pixels, 16)
    k = torch.zeros(4, pm.heads, pm.key_len, 16)
    assert K.fused_site_attention(q, k, k, 0.25, None, pm, 0) is None
    # A CFG batch with no edit row (B = 1).
    assert K.fused_site_attention(q[:2], k[:2], k[:2], 0.25, pc, pm, 0) is None
    # A store site is never fused.
    stored = Controller(edit=pc.edit, store=True)
    sm = next(m for m in unet_layout(TINY.unet).metas if m.store_slot is not None)
    assert kernel_edit_spec(stored, sm) is None


def test_edit_operands_match_the_jax_side():
    from p2p_tpu.controllers.kernel_spec import (
        edit_operands as j_edit_operands, kernel_edit_spec as j_kernel_edit_spec)

    for mode in ("replace", "refine", "reweight"):
        jc = _jax_ctrl(mode)
        pc = _port_ctrl(jc)
        for cross, pixels in ((True, 256), (True, 64), (False, 64)):
            jm, pm = _site(cross, pixels)
            js, ps = j_kernel_edit_spec(jc, jm), kernel_edit_spec(pc, pm)
            assert dataclass_tuple(js) == dataclass_tuple(ps)
            for step in range(STEPS):
                jo = j_edit_operands(jc.edit, js, jnp.int32(step))
                po = edit_operands(pc.edit, ps, step)
                assert sorted(jo) == sorted(po)
                for name in jo:
                    np.testing.assert_array_equal(po[name].numpy(),
                                                  np.asarray(jo[name]))


def dataclass_tuple(spec):
    return (spec.kind, spec.is_cross, spec.has_equalizer, spec.key_len,
            spec.pad_len)


def test_edit_wrapper_on_cpu_counts_nothing():
    K.reset_launch_counts()
    _edit_pair("refine", cross=True, pixels=64, step=1)
    assert K.launch_counts() == {"flash_attn": 0, "fused_edit": 0}
