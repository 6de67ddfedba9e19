"""K1 and K3 in bf16 at d = 64 as ``flash_fwd_sm90_kernel<64>`` computes them
(``p2p_tpu_torch/csrc/flash_fwd_sm90.cu``: wgmma and TMA, 128 keys a tile),
against the JAX package, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there). Here its arithmetic, ``kernels.bf16.flash`` at the
kernel's key tile (``kernels.bf16.K1_STEP`` = 128: each tile's
unnormalized P is rounded to bf16 before P·V), is held against the Pallas
flash kernel under the interpreter at (1, 2, 512, 64) in blocks of 128
(output within 1e-2 of the largest magnitude, K3's ``l`` and ``m`` within
1e-5 relative, the bars of ``tests/test_torch_sd21.py``), and against the
plain version at ragged lengths; the wrapper's routing of bf16 at d = 64 to
the new entry is checked by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import bf16 as kbf16  # noqa: E402
from p2p_tpu_torch.kernels import build, flash  # noqa: E402

TB = torch.bfloat16
D = 64
SCALE = D ** -0.5
KERNEL_TOL = 1e-2      # bf16 outputs, of the largest magnitude
STATS_TOL = 1e-5       # K3's f32 m and l, relative


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(rng, shape):
    """A bf16 array from numpy, as JAX and as torch."""
    j = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TB)


def test_k1_k3_d64_bf16_emulation_at_the_kernel_tile_matches_pallas():
    rng = np.random.RandomState(13)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, (1, 2, 512, D)) for _ in range(3))
    with force_tpu_interpret_mode():
        want = [np.asarray(a.astype(jnp.float32)) for a in
                jnn.flash_attention_residuals(jq, jk, jv, SCALE, 128)]
        want1 = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, SCALE, 128)
                           .astype(jnp.float32))
    assert kbf16.K1_STEP == 128
    out, l, m = kbf16.flash(q, k, v, SCALE, residuals=True)
    assert l.dtype == m.dtype == torch.float32 and l.shape == m.shape == (1, 2, 512)
    out16 = out.to(TB).float()
    errs = {"K1": _rel(out16, want1), "K3 out": _rel(out16, want[0]),
            "l": _rel(l, want[1]), "m": _rel(m, want[2])}
    print(f"\nsm90 tile emulation vs Pallas (blocks of 128): {errs}")
    assert errs["K1"] <= KERNEL_TOL and errs["K3 out"] <= KERNEL_TOL, errs
    assert errs["l"] <= STATS_TOL and errs["m"] <= STATS_TOL, errs
    # The tile moves where P rounds: the parent kernel's 64-key steps round
    # elsewhere, within the same bar.
    out64 = kbf16.flash(q, k, v, SCALE, step=64)
    assert not torch.equal(out64, out)
    assert _rel(out64.to(TB).float(), want1) <= KERNEL_TOL


@pytest.mark.parametrize("sq,sk", [(300, 70), (1000, 1000)])
def test_k1_k3_d64_bf16_emulation_ragged_matches_plain(sq, sk):
    """A query tile past Sq and a key tile past Sk (70 keys: one part-full
    tile; 1000: seven full tiles and one of 104)."""
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn((1, 2, sq, D), generator=g).to(TB)
    k, v = (torch.randn((1, 2, sk, D), generator=g).to(TB) for _ in range(2))
    out, l, m = kbf16.flash(q, k, v, SCALE, residuals=True)
    p_out, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    assert _rel(out.to(TB).float(), p_out.float()) <= KERNEL_TOL
    assert _rel(l, p_l) <= STATS_TOL and _rel(m, p_m) <= STATS_TOL
    # On the CPU the wrappers run the plain versions.
    assert torch.equal(K.flash_attention(q, k, v, SCALE),
                       K.flash_attention_plain(q, k, v, SCALE))
    assert all(torch.equal(a, b) for a, b in zip(
        K.flash_attention_residuals(q, k, v, SCALE), (p_out, p_l, p_m)))


@pytest.mark.parametrize("dtype,d,entry,library", [
    (TB, 64, "p2p_flash_attn_fwd_bf16_sm90", "flash_fwd_sm90"),
    # bf16 at d = 40 and 512 moved to wgmma and TMA; each case keeps the id
    # it was first collected under.
    pytest.param(TB, 40, "p2p_flash_attn_fwd_bf16_sm90", "flash_fwd_sm90",
                 id="dtype1-40-p2p_flash_attn_fwd_bf16-flash_attn"),
    pytest.param(TB, 512, "p2p_flash_attn_fwd_bf16_sm90", "flash_fwd_sm90",
                 id="dtype2-512-p2p_flash_attn_fwd_bf16-flash_attn"),
    # f32 at d = 64 moved to tf32 wgmma and TMA; the case keeps its id.
    pytest.param(torch.float32, 64, "p2p_flash_attn_fwd_f32_sm90", "flash_fwd_tf32_sm90",
                 id="dtype3-64-p2p_flash_attn_fwd-flash_attn"),
])
def test_forward_entry_by_dtype_and_head_dim(dtype, d, entry, library):
    assert flash.entry_for(dtype, d) == entry
    assert flash.ENTRIES[entry] == library
    assert library in build.sources()
    src = (build.CSRC / f"{library}.cu").read_text()
    assert f'extern "C" int {entry}(' in src


def test_sm90_source_runs_on_wgmma_and_tma():
    """The d = 64 bf16 kernel is written on Hopper's instructions (in its
    source and the header of them, shared with K4's sm90 passes, that it
    includes), and the parent's mma.sync kernel is gone."""
    src = (build.CSRC / "flash_fwd_sm90.cu").read_text()
    assert '#include "sm90.cuh"' in src
    text = src + (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "cp.async.bulk.tensor.3d", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "setmaxnreg", "__grid_constant__"):
        assert needle in text, needle
    for call in ("wgmma_ss_n128(", "wgmma_rs_n64(", "tma_load(", "mbar_wait("):
        assert call in src, call
    assert "mma.sync" not in text
    for path in build.CSRC.glob("*.cu"):
        assert "flash_d64_bf16_kernel" not in path.read_text(), path
