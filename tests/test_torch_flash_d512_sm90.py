"""K1 and K3 in bf16 at d = 512 as ``flash_d512_sm90_kernel`` computes them
(``p2p_tpu_torch/csrc/flash_fwd_sm90.cu``: wgmma and TMA, 128 keys a tile,
the keys split among blocks when the query tiles leave SMs idle), against
the JAX package, on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there). Here its arithmetic, ``kernels.bf16.flash`` at the
kernel's key tile (``kernels.bf16.K1_STEP`` = 128: each tile's
unnormalized P is rounded to bf16 before P·V, and ``s·scale2 − m2`` is one
fused multiply-add), is held against the Pallas flash kernel under the
interpreter at (1, 1, 512, 512) in blocks of 256 (output within 1e-2 of
the largest magnitude, K3's ``l`` and ``m`` within 1e-5 relative, the bars
of ``tests/test_torch_bf16_inversion.py``), and against the plain version
at ragged lengths. Then the wrapper's routing of bf16 at d = 512 to the new
entry, the key split's rule at the d = 512 shapes of both dtypes (``key_
splits``, ``d512_splits``), and the merge over those split counts against
the unsplit plain version in f32.
"""

import math

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
D = 512
SCALE = D ** -0.5
KERNEL_TOL = 1e-2      # bf16 outputs, of the largest magnitude
STATS_TOL = 1e-5       # K3's f32 m and l, relative
MERGE_TOL = 1e-5       # the merged f32 output, l and m, of the largest magnitude
SMS = 132              # an H100 SXM


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(rng, shape):
    """A bf16 array from numpy, as JAX and as torch."""
    j = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TB)


def test_k1_k3_d512_bf16_emulation_at_the_kernel_tile_matches_pallas():
    rng = np.random.RandomState(17)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, (1, 1, 512, D)) for _ in range(3))
    with force_tpu_interpret_mode():
        want = [np.asarray(a.astype(jnp.float32)) for a in
                jnn.flash_attention_residuals(jq, jk, jv, SCALE, 256)]
        want1 = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, SCALE, 256)
                           .astype(jnp.float32))
    assert kbf16.K1_STEP == 128
    out, l, m = kbf16.flash(q, k, v, SCALE, residuals=True)
    assert l.dtype == m.dtype == torch.float32 and l.shape == m.shape == (1, 1, 512)
    out16 = out.to(TB).float()
    errs = {"K1": _rel(out16, want1), "K3 out": _rel(out16, want[0]),
            "l": _rel(l, want[1]), "m": _rel(m, want[2])}
    print(f"\nd = 512 sm90 tile emulation vs Pallas (blocks of 256): {errs}")
    assert errs["K1"] <= KERNEL_TOL and errs["K3 out"] <= KERNEL_TOL, errs
    assert errs["l"] <= STATS_TOL and errs["m"] <= STATS_TOL, errs
    # The tile moves where P rounds: the mma.sync kernel's 64-key steps
    # rounded elsewhere, within the same bar.
    out64 = kbf16.flash(q, k, v, SCALE, step=64)
    assert not torch.equal(out64, out)
    assert _rel(out64.to(TB).float(), want1) <= KERNEL_TOL


@pytest.mark.parametrize("sq,sk", [pytest.param(300, 70, id="300-70"),
                                   pytest.param(70, 300, id="70-300")])
def test_k1_k3_d512_bf16_emulation_ragged_matches_plain(sq, sk):
    """A query tile past Sq and a key tile past Sk (70 keys: one part-full
    tile, the second warpgroup's 64 keys all but 6 past it; 300: two full
    tiles and one of 44, the second warpgroup's keys all past it)."""
    g = torch.Generator().manual_seed(sq + 3 * sk)
    q = torch.randn((1, 1, sq, D), generator=g).to(TB)
    k, v = (torch.randn((1, 1, sk, D), generator=g).to(TB) for _ in range(2))
    out, l, m = kbf16.flash(q, k, v, SCALE, residuals=True)
    p_out, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    assert _rel(out.to(TB).float(), p_out.float()) <= KERNEL_TOL
    assert _rel(l, p_l) <= STATS_TOL and _rel(m, p_m) <= STATS_TOL
    # On the CPU the wrappers run the plain versions.
    assert torch.equal(K.flash_attention(q, k, v, SCALE),
                       K.flash_attention_plain(q, k, v, SCALE))
    assert all(torch.equal(a, b) for a, b in zip(
        K.flash_attention_residuals(q, k, v, SCALE), (p_out, p_l, p_m)))


def test_bf16_d512_routes_to_the_sm90_entry():
    entry = flash.entry_for(TB, D)
    assert entry == "p2p_flash_attn_fwd_bf16_sm90"
    assert flash.ENTRIES[entry] == "flash_fwd_sm90"
    assert flash.entry_for(torch.float32, D) == "p2p_flash_attn_fwd"
    assert flash.entry_for(TB, 40) == "p2p_flash_attn_fwd_bf16_sm90"


def test_d512_sm90_source_runs_on_wgmma_and_tma_with_the_shared_merge():
    """The new kernel is written on Hopper's instructions; the mma.sync bf16
    kernel is gone; both d = 512 kernels launch the merge of one header."""
    src = (build.CSRC / "flash_fwd_sm90.cu").read_text()
    sm90 = (build.CSRC / "sm90.cuh").read_text()
    assert "flash_d512_sm90_kernel" in src
    for needle in ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16"):
        assert needle in sm90, needle
    for call in ("wgmma_ss_n64(", "wgmma_ss_n256_tb(", "tma_load_col(",
                 "launch_flash_merge<bf16>("):
        assert call in src, call
    assert "mma.sync" not in src + sm90
    legacy = (build.CSRC / "flash_attn.cu").read_text()
    assert "launch_flash_merge<float>(" in legacy
    assert "namespace d512bf" not in legacy
    for path in build.CSRC.glob("*.cu"):
        text = path.read_text()
        assert "flash_d512_bf16_kernel" not in text, path
        assert "__global__ void __launch_bounds__(d512::D / 4)" not in text, path
    merge = (build.CSRC / "flash_merge.cuh").read_text()
    assert "flash_merge_kernel" in merge
    for name in ("flash_attn", "flash_fwd_sm90"):
        assert '#include "flash_merge.cuh"' in (build.CSRC / f"{name}.cu").read_text()


# The rule at the VAE's d = 512 shapes on a 132-SM card: (blocks, key
# tiles) per dtype (64-key tiles in f32, 128 in bf16), and the splits set
# from the card's timings (PERF.md §6).
@pytest.mark.parametrize("dtype,b,s,want", [
    pytest.param(torch.float32, 1, 9216, 9, id="f32-1-9216"),
    pytest.param(torch.float32, 2, 9216, 5, id="f32-2-9216"),
    pytest.param(TB, 1, 9216, 6, id="bf16-1-9216"),
    pytest.param(TB, 2, 9216, 4, id="bf16-2-9216"),
    pytest.param(torch.float32, 1, 4096, 2, id="f32-1-4096"),
    pytest.param(TB, 1, 4096, 2, id="bf16-1-4096"),
    pytest.param(torch.float32, 2, 4096, 1, id="f32-2-4096"),
])
def test_d512_splits_at_the_vae_shapes(dtype, b, s, want):
    tile = flash.D512_KEY_TILE[dtype]
    blocks, key_tiles = b * -(-s // flash.D512_TILE), -(-s // tile)
    n = flash.d512_splits(dtype, b, s, s, SMS)
    assert n == want
    assert n == flash.key_splits(blocks, key_tiles, SMS, flash.D512_MERGE[dtype])
    if blocks >= SMS and n > 1:
        # A short last round filled: fewer rounds times key tiles than unsplit.
        assert (math.ceil(blocks * n / SMS) * math.ceil(key_tiles / n)
                < math.ceil(blocks / SMS) * key_tiles)


def test_key_splits_full_rounds():
    # 144 and 288 blocks of 144 64-key tiles ((1 and 2, 1, 9216, 512) in
    # f32): the short last round (12 and 24 blocks of 132 SMs) is filled.
    assert flash.key_splits(144, 144, SMS) == 9
    assert flash.key_splits(288, 144, SMS) == 5
    # Without the merge's cost the rounds alone would pick more splits.
    assert flash.key_splits(288, 144, SMS, merge=0.0) == 16
    # The rule below one round is unchanged, and full rounds stay unsplit.
    assert flash.key_splits(64, 64, SMS) == 2 and flash.key_splits(128, 64, SMS) == 1
    assert flash.key_splits(132, 64, SMS) == 1 and flash.key_splits(512, 64, SMS) == 1
    for blocks in range(SMS, 4 * SMS):
        n = flash.key_splits(blocks, 72, SMS, flash.D512_MERGE[TB])
        assert 1 <= n <= flash.MAX_KEY_SPLITS


def _split_partials(q, k, v, scale, nsplit, tile):
    """Each key split's unnormalized output, row sum and row max as the
    kernels write them: split z takes key tiles [z·T/n, (z+1)·T/n)."""
    sk = k.shape[-2]
    tiles = -(-sk // tile)
    outs, ls, ms = [], [], []
    for z in range(nsplit):
        k0, k1 = z * tiles // nsplit * tile, min((z + 1) * tiles // nsplit * tile, sk)
        o, l, m = K.flash_attention_residuals_plain(q, k[..., k0:k1, :], v[..., k0:k1, :],
                                                    scale)
        outs.append(o * l[..., None])
        ls.append(l)
        ms.append(m)
    return outs, ls, ms


@pytest.mark.parametrize("dtype,nsplit", [
    pytest.param(torch.float32, 9, id="f32-9"), pytest.param(torch.float32, 5, id="f32-5"),
    pytest.param(TB, 6, id="bf16-6"), pytest.param(TB, 4, id="bf16-4"),
])
def test_merge_over_the_new_split_counts_equals_the_whole(dtype, nsplit):
    """The plain merge of ``nsplit`` key ranges in the tiles of ``dtype``'s
    kernel, in f32, against the unsplit plain version."""
    tile = flash.D512_KEY_TILE[dtype]
    sk = (2 * nsplit - 1) * tile + 37    # uneven splits and a ragged last tile
    g = torch.Generator().manual_seed(nsplit)
    q = torch.randn((1, 1, 100, D), generator=g)
    k, v = (torch.randn((1, 1, sk, D), generator=g) for _ in range(2))
    got = flash.merge_partials(*_split_partials(q, k, v, SCALE, nsplit, tile))
    want = K.flash_attention_residuals_plain(q, k, v, SCALE)
    for name, a, w in zip(("out", "l", "m"), got, want):
        assert a.shape == w.shape, name
        assert _rel(a, w) <= MERGE_TOL, name


@pytest.mark.parametrize("name", [
    pytest.param("void (anonymous namespace)::flash_d512_sm90_kernel(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 *, float *, float *, float *, "
                 "int, int, float)", id="kernel"),
    pytest.param("void p2p::flash_merge_kernel<__nv_bfloat16>(const float *, const float *, "
                 "const float *, __nv_bfloat16 *, float *, float *, int, int)", id="merge")])
def test_profile_step_counts_the_d512_kernel_as_k1(name):
    """``profile_step``'s breakdown puts the new kernel and its merge in K1's
    class."""
    from p2p_tpu_torch import profile_step

    assert profile_step._class(name) == "K1/K3 flash_attn"
