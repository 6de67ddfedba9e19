"""K2's folded form on the tensor cores, on the CPU.

The CUDA kernels of ``p2p_tpu_torch/csrc/fused_edit.cu`` fold the
prompt-to-prompt edit into the values: every edit operand scales a key
column, so for an edit row ``e``

    out_e = softmax(q_B·k_Bᵀ·s) @ V1_e + softmax(q_e·k_eᵀ·s) @ V2_e
    V1_e  = M_e·diag(c1_e)·v_e,  c1 = ra·eq·α
    V2_e  = diag(c2_e)·v_e,      c2 = (1 − ra)·eq·α + (1 − α)

and a pass is skipped where its ``c`` is 0 on every key. The kernels run only
on the card, where ``chip_smoke.py`` holds them within 1e-5 of the largest
magnitude of ``edit_attention_plain``; here the fold in plain f32 and the
kernels' emulation (``tf32.fused_edit_folded``: the fold in f32, each pass's
products in 3xTF32 per step of ``STEP_KEYS`` keys, added in f32) are held
against a float64 evaluation of the plain formula and against the JAX
package's Pallas kernel under the interpreter, on numpy-seeded inputs: TINY
sites with the real Replace, Refine and Reweight operands and self injection
inside and outside its window, a fractional α (both passes), a zero weight on
every key (no pass), SD-1.4 head dims at a small P, and keys that are not a
multiple of 8 over two steps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.align.words import get_equalizer  # noqa: E402
from p2p_tpu.controllers import factory as jfactory  # noqa: E402
from p2p_tpu.controllers.kernel_spec import EditSpec as JEditSpec  # noqa: E402
from p2p_tpu.kernels.fused_edit import edit_attention as j_edit_attention  # noqa: E402
from p2p_tpu.models.config import TINY as J_TINY  # noqa: E402
from p2p_tpu.utils.tokenizer import HashWordTokenizer as JTok  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.controllers.base import Controller  # noqa: E402
from p2p_tpu_torch.controllers.edit import EditParams  # noqa: E402
from p2p_tpu_torch.controllers.factory import attention_replace  # noqa: E402
from p2p_tpu_torch.controllers.kernel_spec import (  # noqa: E402
    EditSpec,
    edit_operands,
    kernel_edit_spec,
    padded_key_len,
)
from p2p_tpu_torch.kernels import fused_edit as fe  # noqa: E402
from p2p_tpu_torch.kernels import tf32  # noqa: E402
from p2p_tpu_torch.models.config import SD14, TINY, unet_layout  # noqa: E402
from p2p_tpu_torch.utils.tokenizer import HashWordTokenizer  # noqa: E402

PROMPTS = ["a cat riding a bike", "the dog eating some pizza"]
SD_PROMPTS = ["a cat riding a bicycle", "a dog riding a bicycle"]
STEPS = 3       # TINY: α is 1 at steps 0-2 and 0 at step 3; the self window is step 0
SD_STEPS = 50   # SD-1.4: the cross window holds steps < 40, the self window < 20

# Both sides compute the same f32 formula; only the order of the sums and
# the 3xTF32 products differ (tests/test_torch_kernels.py).
EDIT_TOL = 1e-5
# Each f32 evaluation against float64, relative to the largest magnitude.
F64_TOL = 2e-6


def _jax_ctrl(mode):
    tok = JTok(model_max_length=J_TINY.text.max_length)
    kw = dict(tokenizer=tok, max_len=J_TINY.text.max_length,
              self_max_pixels=J_TINY.unet.sample_size ** 2, store=False)
    if mode == "replace":
        return jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, **kw)
    if mode == "refine":
        return jfactory.attention_refine(PROMPTS, STEPS, 0.8, 0.4, **kw)
    base = jfactory.attention_replace(PROMPTS, STEPS, 0.8, 0.4, **kw)
    eq = get_equalizer(PROMPTS[1], ["dog"], [3.0], tok, mode="paired")
    return jfactory.attention_reweight(PROMPTS, STEPS, 0.8, 0.4, eq, base=base, **kw)


def _port_ctrl(jc) -> Controller:
    """The port's controller holding the JAX controller's parameters."""
    e = jc.edit

    def t(x, dtype):
        return None if x is None else torch.from_numpy(np.array(x)).to(dtype)

    edit = EditParams(
        cross_alpha=t(e.cross_alpha, torch.float32),
        mapper=t(e.mapper, torch.float32 if e.kind == "replace" else torch.int64),
        refine_alphas=t(e.refine_alphas, torch.float32),
        equalizer=t(e.equalizer, torch.float32),
        self_start=int(e.self_start), self_end=int(e.self_end),
        kind=e.kind, self_max_pixels=e.self_max_pixels)
    return Controller(edit=edit, store=jc.store)


def _meta(cfg, cross, pixels):
    return next(m for m in unet_layout(cfg.unet).metas
                if m.is_cross == cross and m.pixels == pixels)


def _qkv(seed, heads, pixels, keys, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(4, heads, n, d).astype(np.float32))
            for n in (pixels, keys, keys)]


def _tiny(mode, cross, pixels, step, seed, edit_ops=None):
    meta = _meta(TINY, cross, pixels)
    spec = kernel_edit_spec(_port_ctrl(_jax_ctrl(mode)), meta)
    ops = edit_operands(_port_ctrl(_jax_ctrl(mode)).edit, spec, step)
    if edit_ops is not None:
        ops = edit_ops(ops, spec)
    d = meta.channels // meta.heads
    return (*_qkv(seed, meta.heads, meta.pixels, meta.key_len, d), d ** -0.5, spec, ops)


def _fractional(ops, spec):
    """α strictly between 0 and 1: both passes run."""
    rng = np.random.RandomState(7)
    blend = np.zeros(ops["blend"].shape, np.float32)
    blend[:, :spec.key_len] = rng.uniform(0.1, 0.9, (blend.shape[0], spec.key_len))
    return {**ops, "blend": torch.from_numpy(blend)}


def _zero_weight(ops, spec):
    """Reweight by 0 inside the window (α = 1): every key's weight is 0."""
    return {**ops, "equalizer": torch.zeros_like(ops["equalizer"])}


def _sd(cross, pixels, d, step, seed, heads=2):
    """SD-1.4's head dim and keys at a site, with the Replace controller's
    operands at ``step``; heads and query rows cut."""
    ctrl = attention_replace(SD_PROMPTS, SD_STEPS, 0.8, 0.4, HashWordTokenizer(),
                             store=False)
    meta = next(m for m in unet_layout(SD14.unet).metas
                if m.is_cross == cross and m.channels // m.heads == d
                and (cross or m.pixels == pixels))
    spec = kernel_edit_spec(ctrl, meta)
    return (*_qkv(seed, heads, pixels, meta.key_len, d), d ** -0.5, spec,
            edit_operands(ctrl.edit, spec, step))


def _ragged(d=40, keys=100, pixels=48, seed=9):
    """Refine-like operands drawn at random over K = 100 keys: two steps of
    80 at D = 40, the second ragged, and every operand fractional."""
    rng = np.random.RandomState(seed)
    kp = padded_key_len(keys)
    spec = EditSpec("refine", True, True, keys, kp)

    def pad(x, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return torch.from_numpy(out)

    ops = {"transform": pad(rng.uniform(0, 2.0 / keys, (1, keys, keys)), (1, kp, kp)),
           "refine_mix": pad(rng.uniform(0, 1, (1, keys)), (1, kp)),
           "equalizer": pad(rng.uniform(0.5, 2, (1, keys)), (1, kp)),
           "blend": pad(rng.uniform(0, 1, (1, keys)), (1, kp))}
    return (*_qkv(seed, 2, pixels, keys, d), d ** -0.5, spec, ops)


# name: (inputs, (c1 ≡ 0, c2 ≡ 0) of the edit row)
CASES = {
    "tiny-replace": (lambda: _tiny("replace", True, 256, 0, 1), (False, True)),
    "tiny-replace-after-window": (lambda: _tiny("replace", True, 256, 3, 2), (True, False)),
    "tiny-refine": (lambda: _tiny("refine", True, 256, 0, 3), (False, False)),
    "tiny-reweight": (lambda: _tiny("reweight", True, 256, 0, 4), (False, True)),
    "tiny-self-in-window": (lambda: _tiny("replace", False, 64, 0, 5), (False, True)),
    "tiny-self-after-window": (lambda: _tiny("replace", False, 64, 2, 6), (True, False)),
    "tiny-fractional-alpha": (lambda: _tiny("refine", True, 64, 0, 7, _fractional),
                              (False, False)),
    "tiny-zero-weight": (lambda: _tiny("reweight", True, 64, 0, 8, _zero_weight),
                         (True, True)),
    "sd-cross-d40": (lambda: _sd(True, 64, 40, 0, 10), (False, True)),
    "sd-cross-d80": (lambda: _sd(True, 64, 80, 45, 11), (True, False)),
    "sd-cross-d160": (lambda: _sd(True, 64, 160, 0, 12), (False, True)),
    "sd-self-k256": (lambda: _sd(False, 256, 160, 0, 13), (False, True)),
    "sd-self-k64": (lambda: _sd(False, 64, 160, 45, 14), (True, False)),
    "ragged-k100": (_ragged, (False, False)),
}


def _exact(q, k, v, scale, spec, ops):
    """``edit_attention_plain``'s formula in float64 on the unpadded keys."""
    n = spec.key_len
    b_half = q.shape[0] // 2
    s = q.double() @ k.double().transpose(-1, -2) * scale
    probs = torch.softmax(s, dim=-1)
    base, edits = probs[b_half], probs[b_half + 1:]

    def row(name):
        return ops[name][:, None, None, :n].double()

    if spec.has_transform:
        new = torch.einsum("hpw,ewn->ehpn", base, ops["transform"][:, :n, :n].double())
    else:
        new = base[None].expand_as(edits)
    if spec.kind == "refine":
        new = new * row("refine_mix") + edits * (1.0 - row("refine_mix"))
    if spec.has_equalizer:
        new = new * row("equalizer")
    alpha = row("blend")
    edited = new * alpha + (1.0 - alpha) * edits
    return torch.cat([probs[:b_half + 1], edited]) @ v.double()


def _rel(got, want) -> float:
    top = max(want.double().abs().max().item(), 1e-30)
    return (got.double() - want.double()).abs().max().item() / top


@pytest.mark.parametrize("name", list(CASES))
def test_fold_and_emulation_match_float64(name):
    """The folded form in plain f32 and as the kernels compute it are each
    within 2e-6 of float64 (relative to the largest magnitude), and the fold
    flags the passes that the edit row skips."""
    make, flags = CASES[name]
    q, k, v, scale, spec, ops = make()
    b_half = q.shape[0] // 2
    v1, v2, c1_zero, c2_zero = fe.fold_operands(v[b_half + 1:], spec, ops)
    assert (bool(c1_zero[0]), bool(c2_zero[0])) == flags
    assert v1.shape == v2.shape == v[b_half + 1:].shape
    exact = _exact(q, k, v, scale, spec, ops)
    plain = tf32.fused_edit_folded(q, k, v, scale, spec, ops, mm=torch.matmul)
    emulated = tf32.fused_edit_folded(q, k, v, scale, spec, ops)
    assert plain.shape == emulated.shape == q.shape and emulated.dtype == torch.float32
    assert _rel(plain, exact) <= F64_TOL, _rel(plain, exact)
    assert _rel(emulated, exact) <= F64_TOL, _rel(emulated, exact)
    # The unfolded plain version, the reference the kernels are held to on
    # the card, agrees with both.
    unfolded = K.edit_attention_plain(q, k, v, scale, spec, ops)
    assert _rel(unfolded, exact) <= F64_TOL
    if flags == (True, True):
        assert not emulated[b_half + 1:].any()


@pytest.mark.parametrize("name", list(CASES))
def test_folded_matches_pallas_interpret(name):
    """The folded form, plain and emulated, against the JAX package's Pallas
    kernel under the interpreter on the same inputs and operands."""
    q, k, v, scale, spec, ops = CASES[name][0]()
    want = np.asarray(j_edit_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), scale,
        JEditSpec(**dataclasses.asdict(spec)),
        {n: jnp.asarray(t.numpy()) for n, t in ops.items()}, interpret=True))
    for mm in (torch.matmul, tf32.mm_3xtf32):
        got = tf32.fused_edit_folded(q, k, v, scale, spec, ops, mm=mm).numpy()
        assert np.abs(got - want).max() <= EDIT_TOL, (mm, np.abs(got - want).max())


def test_step_keys_cover_every_head_dim():
    """The emulation knows the main kernel's step at every instantiated head
    dim, and a cross site's 77 keys are one step at D = 40 (no rescale)."""
    assert sorted(fe.STEP_KEYS) == sorted(fe.SUPPORTED_HEAD_DIMS)
    assert all(s % 8 == 0 for s in fe.STEP_KEYS.values())
    assert fe.STEP_KEYS[40] >= 77


def test_wrapper_on_cpu_runs_plain_and_launches_no_fold():
    q, k, v, scale, spec, ops = _sd(True, 64, 40, 0, 15)
    K.reset_launch_counts()
    out = K.edit_attention(q, k, v, scale, spec, ops)
    assert torch.equal(out, K.edit_attention_plain(q, k, v, scale, spec, ops))
    assert K.fold_launches() == 0
    assert K.launch_counts()["fused_edit"] == 0


def test_one_tf32_pass_misses_the_bound():
    """The bound separates the kernels' arithmetic from one TF32 pass: with
    each product a single TF32 product the folded form is some 1e-4 off."""
    q, k, v, scale, spec, ops = CASES["sd-self-k256"][0]()
    exact = _exact(q, k, v, scale, spec, ops)
    one_pass = tf32.fused_edit_folded(q, k, v, scale, spec, ops, mm=tf32.mm_1xtf32)
    assert _rel(one_pass, exact) > 50 * F64_TOL
