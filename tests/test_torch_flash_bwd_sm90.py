"""K4 in bf16 at d = 64 as ``flash_bwd_dkv_sm90_kernel`` and
``flash_bwd_dq_sm90_kernel`` compute it (``p2p_tpu_torch/csrc/
flash_bwd_sm90.cu``: wgmma and TMA, 128 rows a block), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain passes there, within 1e-2 of the plain output's largest magnitude).
Their rounding points do not depend on the tile, so the plain passes stay
their yardstick; here the bf16 plain passes at d = 64 are held against
float64 materialized autograd at the ragged lengths the card checks, the
wrappers' routing of bf16 at d = 64 to the new entries is checked by name,
and the sources by the instructions they are written on.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash_bwd  # noqa: E402

TB = torch.bfloat16
D = 64
SCALE = D ** -0.5
KERNEL_TOL = 1e-2      # bf16 gradients, of the largest magnitude


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(sq, sk, seed):
    """bf16 q, do (1, 2, sq, 64) and k, v (1, 2, sk, 64) from numpy."""
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(1, 2, sq, D).astype(np.float32)).to(TB)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 2, sk, D).astype(np.float32)).to(TB)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("pass_,dtype,d,entry,library", [
    ("dkv", TB, 64, "p2p_flash_attn_bwd_dkv_bf16_sm90", "flash_bwd_sm90"),
    ("dq", TB, 64, "p2p_flash_attn_bwd_dq_bf16_sm90", "flash_bwd_sm90"),
    ("dkv", TB, 40, "p2p_flash_attn_bwd_dkv_bf16", "flash_attn_bwd"),
    ("dq", torch.float32, 64, "p2p_flash_attn_bwd_dq", "flash_attn_bwd"),
    ("dkv", torch.float32, 40, "p2p_flash_attn_bwd_dkv", "flash_attn_bwd"),
])
def test_backward_entry_by_dtype_and_head_dim(pass_, dtype, d, entry, library):
    assert flash_bwd.entry_for(pass_, dtype, d) == entry
    assert flash_bwd.ENTRIES[entry] == library
    assert library in build.sources()
    src = (build.CSRC / f"{library}.cu").read_text()
    assert f'extern "C" int {entry}(' in src


def test_sm90_backward_source_runs_on_wgmma_and_tma():
    """Both passes are written on Hopper's instructions (the source and the
    header of them it includes), with no mma.sync."""
    src = (build.CSRC / "flash_bwd_sm90.cu").read_text()
    assert '#include "sm90.cuh"' in src
    text = src + (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "cp.async.bulk.tensor.3d", "mbarrier.try_wait", "mbarrier.arrive",
                   "CU_TENSOR_MAP_SWIZZLE_128B", "__grid_constant__"):
        assert needle in text, needle
    for kernel in ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"):
        assert f"{kernel}(" in src, kernel
    for call in ("wgmma_rs_kb<BT>(", "wgmma_rs_n64(", "tma_load(", "mbar_wait("):
        assert call in src, call
    assert "mma.sync" not in text


def test_mma_sync_bf16_passes_left_only_at_d40():
    """``flash_attn_bwd.cu`` keeps its bf16 passes at d = 40 and f32 at 40
    and 64; bf16 at 64 is the sm90 source's."""
    src = (build.CSRC / "flash_attn_bwd.cu").read_text()
    assert re.findall(r"launch_bf16<(\d+)>\(", src) == ["40"]
    assert sorted(set(re.findall(r"launch_f32<(\d+)>\(", src))) == ["40", "64"]
    assert "flash_bwd_dkv_bf16_kernel<64>" not in src
    assert "flash_bwd_dq_bf16_kernel<64>" not in src


@pytest.mark.parametrize("sq,sk", [(300, 70), (70, 300)])
def test_bf16_plain_passes_d64_match_float64_autograd(sq, sk):
    """The yardstick the card holds the new kernels to: the bf16 plain
    passes at d = 64, from K3's plain residuals and ``di`` as the wrapper
    takes them, against float64 autograd of the materialized attention on
    the same bf16 values; at the ragged lengths chip_smoke checks (a part
    tile of queries and of keys, more queries than keys and fewer)."""
    q, k, v, do = _operands(sq, sk, sq + 3 * sk)
    o, l, m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, SCALE)
    dq = K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, SCALE)
    assert dq.dtype == dk.dtype == dv.dtype == TB
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape

    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * SCALE, dim=-1) @ v64
    want = torch.autograd.grad(out, (q64, k64, v64), do.double())
    errs = {name: _rel(got.float(), w) for name, got, w in
            zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    print(f"\nK4 bf16 d=64 plain vs float64 autograd, Sq={sq} Sk={sk}: {errs}")
    assert max(errs.values()) <= KERNEL_TOL, errs


def test_wrappers_take_the_plain_passes_on_the_cpu():
    """On CPU tensors the bf16 d = 64 wrappers run the plain passes and
    count no launch."""
    q, k, v, do = _operands(130, 200, 11)
    o, l, m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    di = (o.float() * do.float()).sum(dim=-1)
    before = (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
              dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
              flash_bwd.flash_attention_bwd_dkv.bf16_launches,
              flash_bwd.flash_attention_bwd_dq.bf16_launches)
    got = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, SCALE)
    want = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(K.flash_attention_bwd_dq(q, k, v, do, l, m, di, SCALE),
                       K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, SCALE))
    assert before == (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
                      dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
                      flash_bwd.flash_attention_bwd_dkv.bf16_launches,
                      flash_bwd.flash_attention_bwd_dq.bf16_launches)


def test_launch_refuses_a_cpu_tensor():
    """The launch path has no fallback: it raises on anything but a CUDA
    tensor, before any library is built."""
    q, k, v, do = _operands(70, 70, 5)
    o, l, m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    di = (o.float() * do.float()).sum(dim=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_bwd._launch(flash_bwd.flash_attention_bwd_dq, "dq",
                          (q, k, v, do, l, m, di), (torch.empty_like(q),), SCALE)
