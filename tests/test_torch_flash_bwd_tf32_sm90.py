"""K4 in f32 at d = 64 as ``flash_bwd_dkv_tf32_sm90_kernel`` and
``flash_bwd_dq_tf32_sm90_kernel`` compute it (``p2p_tpu_torch/csrc/
flash_bwd_tf32_sm90.cu``: 3xTF32 on wgmma, tiles landed by TMA, 128 rows a
block, the other side streamed in 32-row tiles), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain passes there, within 1e-5 of the plain output's largest magnitude).
Here the wrappers' routing of f32 at d = 64 to the new entries (and of d =
40 to ``flash_attn_bwd.cu``) is checked by name, the source by the
instructions it is written on, and the kernels' arithmetic by its plain
emulation (``kernels/tf32.py``: the 3xTF32 products tile by tile at the
kernels' tile length, each tile's sum added in f32) against the plain
passes and float64 autograd.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash_bwd, tf32  # noqa: E402

TC_TOL = 1e-5          # f32 gradients, of the largest magnitude
SOURCE = "flash_bwd_tf32_sm90"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _case(sq, sk, seed, d=64):
    """f32 q, do (1, 2, sq, d) and k, v (1, 2, sk, d) from numpy, K3's plain
    residuals and ``di`` as the wrapper takes it."""
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(1, 2, sq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 2, sk, d).astype(np.float32)) for _ in range(2))
    scale = d ** -0.5
    o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
    di = (o * do).sum(dim=-1)
    return (q, k, v, do, l, m, di), scale


@pytest.mark.parametrize("pass_,d,entry,library", [
    pytest.param("dkv", 64, "p2p_flash_attn_bwd_dkv_f32_sm90", SOURCE, id="dkv-64"),
    pytest.param("dq", 64, "p2p_flash_attn_bwd_dq_f32_sm90", SOURCE, id="dq-64"),
    pytest.param("dkv", 40, "p2p_flash_attn_bwd_dkv", "flash_attn_bwd", id="dkv-40"),
    pytest.param("dq", 40, "p2p_flash_attn_bwd_dq", "flash_attn_bwd", id="dq-40"),
])
def test_f32_entry_by_head_dim(pass_, d, entry, library):
    """f32 at d = 64 runs the new sm90 passes, at d = 40 the ``mma.sync``
    passes; each entry lives in the library the wrapper builds for it."""
    assert flash_bwd.entry_for(pass_, torch.float32, d) == entry
    assert flash_bwd.ENTRIES[entry] == library
    assert library in build.sources()
    src = (build.CSRC / f"{library}.cu").read_text()
    assert f'extern "C" int {entry}(' in src


def test_source_runs_on_tf32_wgmma_and_tma():
    """Both passes are written on Hopper's instructions (the source and the
    header of them it includes): tf32 wgmma, TMA on mbarriers, f32 tensor
    maps in 32-column boxes; no mma.sync, and the d = 64 instantiations
    have left flash_attn_bwd.cu."""
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    assert '#include "sm90.cuh"' in src
    text = src + (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
                   "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                   "cp.async.bulk.tensor.3d", "mbarrier.try_wait",
                   "mbarrier.arrive.expect_tx", "fence.proxy.async",
                   "CU_TENSOR_MAP_DATA_TYPE_FLOAT32", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "__grid_constant__"):
        assert needle in text, needle
    assert not re.search(r"wgmma\.mma_async\S*\.tf32\.tf32[^;]*, 1, 1, [01]", text), \
        "tf32 wgmma takes no transpose operands"
    for kernel in ("flash_bwd_dkv_tf32_sm90_kernel", "flash_bwd_dq_tf32_sm90_kernel"):
        assert f"{kernel}(" in src, kernel
    for call in ("wgmma_ss_tf32_n32(", "wgmma_rs_tf32_n64(", "tma_load_col(", "mbar_wait(",
                 "encode_rows_f32(", "split_tf32("):
        assert call in src, call
    assert "mma.sync" not in text
    old = (build.CSRC / "flash_attn_bwd.cu").read_text()
    assert "<64>" not in old


@pytest.mark.parametrize("sq,sk", [
    pytest.param(512, 512, id="512"), pytest.param(300, 70, id="300-70"),
    pytest.param(70, 300, id="70-300")])
def test_emulation_matches_plain_and_float64(sq, sk):
    """The new passes' arithmetic (3xTF32 products 32 rows a tile, each
    tile's sum added in f32) within ``TC_TOL`` of the plain passes, the
    card's yardstick, and of float64 autograd of the materialized attention
    on the same values; at a whole number of tiles and at the ragged
    lengths chip_smoke checks."""
    ops, scale = _case(sq, sk, sq + 7 * sk)
    q, k, v, do = ops[:4]
    dk, dv = tf32.flash_bwd_dkv_tiles(*ops, scale)
    dq = tf32.flash_bwd_dq_tiles(*ops, scale)
    p_dk, p_dv = K.flash_attention_bwd_dkv_plain(*ops, scale)
    p_dq = K.flash_attention_bwd_dq_plain(*ops, scale)

    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1) @ v64
    want = torch.autograd.grad(out, (q64, k64, v64), do.double())
    errs = {}
    for name, got, plain, exact in zip(("dq", "dk", "dv"), (dq, dk, dv), (p_dq, p_dk, p_dv),
                                       want):
        assert got.dtype == torch.float32 and got.shape == plain.shape
        errs[f"{name} vs plain"] = _rel(got, plain)
        errs[f"{name} vs float64"] = _rel(got, exact.detach())
        errs[f"{name} plain vs float64"] = _rel(plain, exact.detach())
    print(f"\nK4 f32 d=64 tiles vs plain and float64, Sq={sq} Sk={sk}: {errs}")
    assert max(errs.values()) <= TC_TOL, errs


def test_one_tf32_product_fails_the_bar():
    """The bar has teeth: the same tiles with one TF32 product a term
    (``mm_1xtf32``) miss ``TC_TOL`` of float64."""
    ops, scale = _case(256, 256, 3)
    q, k, v, do = ops[:4]
    dk, dv = tf32.flash_bwd_dkv_tiles(*ops, scale, mm=tf32.mm_1xtf32)
    dq = tf32.flash_bwd_dq_tiles(*ops, scale, mm=tf32.mm_1xtf32)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1) @ v64
    want = torch.autograd.grad(out, (q64, k64, v64), do.double())
    errs = [_rel(got, w.detach()) for got, w in zip((dq, dk, dv), want)]
    assert min(errs) > 10 * TC_TOL, errs


def test_wrappers_take_the_plain_passes_on_the_cpu():
    """On CPU tensors the f32 wrappers at d = 64 run the plain passes and
    count no launch."""
    ops, scale = _case(130, 200, 11)
    before = (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
              dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
              flash_bwd.flash_attention_bwd_dkv.launches,
              flash_bwd.flash_attention_bwd_dq.launches)
    got = K.flash_attention_bwd_dkv(*ops, scale)
    want = K.flash_attention_bwd_dkv_plain(*ops, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(K.flash_attention_bwd_dq(*ops, scale),
                       K.flash_attention_bwd_dq_plain(*ops, scale))
    assert before == (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
                      dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
                      flash_bwd.flash_attention_bwd_dkv.launches,
                      flash_bwd.flash_attention_bwd_dq.launches)


@pytest.mark.parametrize("name,cls", [
    pytest.param("void (anonymous namespace)::flash_bwd_dkv_tf32_sm90_kernel(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, const float *, const float *, "
                 "const float *, float *, float *, int, int, float)", "K4 flash_attn_bwd dkv",
                 id="dkv"),
    pytest.param("void (anonymous namespace)::flash_bwd_dq_tf32_sm90_kernel(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, const float *, const float *, "
                 "const float *, float *, int, int, float)", "K4 flash_attn_bwd dq", id="dq")])
def test_profile_step_counts_the_new_passes_as_k4(name, cls):
    """``profile_step``'s breakdown puts the new kernels in K4's classes."""
    from p2p_tpu_torch import profile_step

    assert profile_step._class(name) == cls


def test_launch_refuses_a_cpu_tensor():
    """The f32 launch path has no fallback: it raises on anything but a
    CUDA tensor, before any library is built."""
    ops, scale = _case(70, 70, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_bwd._launch(flash_bwd.flash_attention_bwd_dkv, "dkv", ops,
                          (torch.empty_like(ops[1]), torch.empty_like(ops[2])), scale)
