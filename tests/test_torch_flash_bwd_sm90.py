"""K4 in bf16 at d = 40 and 64 as ``flash_bwd_dkv_sm90_kernel`` and
``flash_bwd_dq_sm90_kernel`` compute it (``p2p_tpu_torch/csrc/
flash_bwd_sm90.cu``: wgmma and TMA, 128 rows a block, templated on the
head dim; at d = 40 the rows land by TMA in zero-filled 64-column boxes),
on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain passes there, within 1e-2 of the plain output's largest magnitude).
Their rounding points do not depend on the tile, so the plain passes stay
their yardstick; here the bf16 plain passes at both head dims are held
against float64 materialized autograd at the ragged lengths the card
checks, the wrappers' routing of bf16 to the sm90 entries is checked by
name, and the sources by the instructions they are written on.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash_bwd  # noqa: E402

TB = torch.bfloat16
KERNEL_TOL = 1e-2      # bf16 gradients, of the largest magnitude


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(sq, sk, seed, d=64):
    """bf16 q, do (1, 2, sq, d) and k, v (1, 2, sk, d) from numpy."""
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(1, 2, sq, d).astype(np.float32)).to(TB)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 2, sk, d).astype(np.float32)).to(TB)
            for _ in range(2))
    return q, k, v, do


# Each case keeps the id it was first collected under, so that runs of
# different versions compare case by case.
@pytest.mark.parametrize("pass_,dtype,d,entry,library", [
    pytest.param("dkv", TB, 64, "p2p_flash_attn_bwd_dkv_bf16_sm90", "flash_bwd_sm90",
                 id="dkv-dtype0-64-p2p_flash_attn_bwd_dkv_bf16_sm90-flash_bwd_sm90"),
    pytest.param("dq", TB, 64, "p2p_flash_attn_bwd_dq_bf16_sm90", "flash_bwd_sm90",
                 id="dq-dtype1-64-p2p_flash_attn_bwd_dq_bf16_sm90-flash_bwd_sm90"),
    pytest.param("dkv", TB, 40, "p2p_flash_attn_bwd_dkv_bf16_sm90", "flash_bwd_sm90",
                 id="dkv-dtype2-40-p2p_flash_attn_bwd_dkv_bf16-flash_attn_bwd"),
    pytest.param("dq", torch.float32, 64, "p2p_flash_attn_bwd_dq", "flash_attn_bwd",
                 id="dq-dtype3-64-p2p_flash_attn_bwd_dq-flash_attn_bwd"),
    pytest.param("dkv", torch.float32, 40, "p2p_flash_attn_bwd_dkv", "flash_attn_bwd",
                 id="dkv-dtype4-40-p2p_flash_attn_bwd_dkv-flash_attn_bwd"),
    pytest.param("dq", TB, 40, "p2p_flash_attn_bwd_dq_bf16_sm90", "flash_bwd_sm90",
                 id="dq-bf16-40-p2p_flash_attn_bwd_dq_bf16_sm90-flash_bwd_sm90"),
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
    """``flash_attn_bwd.cu`` has no bf16 (``mma.sync``) pass left, at d = 40
    or any other head dim (bf16 at both head dims is the sm90 source's),
    and instantiates its f32 passes at 40 and 64."""
    src = (build.CSRC / "flash_attn_bwd.cu").read_text()
    assert "launch_bf16" not in src
    assert "_bf16_kernel" not in src
    assert "bf16*" not in src
    assert not re.findall(r'extern "C" int (p2p_flash_attn_bwd_\w*bf16\w*)\(', src)
    assert sorted(set(re.findall(r"launch_f32<(\d+)>\(", src))) == ["40", "64"]
    assert not [e for e in flash_bwd.ENTRIES if e.endswith("_bf16")]


def test_sm90_passes_take_both_head_dims_in_64_column_boxes():
    """The tensor-map encoder takes the tensor's width and lands it in a
    64-column box; both passes are instantiated at d = 40 and 64, and the
    products that contract over d run (DH + 15) / 16 k16 steps."""
    header = (build.CSRC / "sm90.cuh").read_text()
    assert re.search(r"inline bool encode_rows\(EncodeTiled fn, CUtensorMap\* map, "
                     r"const void\* ptr, int d,", header)
    assert "encode_rows64" not in header
    assert "dims[3] = {(cuuint64_t)d," in header
    assert "box[3] = {(cuuint32_t)BOX_COLS," in header
    assert "constexpr int BOX_COLS = 64;" in header
    assert "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE" in header
    src = (build.CSRC / "flash_bwd_sm90.cu").read_text()
    for kernel in ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"):
        assert sorted(set(re.findall(rf"{kernel}<(\d+)>", src))) == ["40", "64"], kernel
    assert re.search(r"d != 40 && d != 64", src)
    assert len(re.findall(r"encode_rows\(fn, &maps\[\d\], \w+, d,", src)) == 4
    assert "return (DH + 15) / 16;" in src
    assert src.count("KS = d_steps<DH>()") == 2
    loops = re.findall(r"for \(int ks = 0; ks < (\w+); \+\+ks\) wgmma_rs_kb<BT>", src)
    assert loops == ["KS"] * 4, loops
    assert src.count("load_a_sw128<KS>(") == 4
    assert src.count("store_rows<DH>(") == 3
    fwd = (build.CSRC / "flash_fwd_sm90.cu").read_text()
    assert len(re.findall(r"encode_rows\(fn, &t[qkv], [qkv], D,", fwd)) == 3


@pytest.mark.parametrize("sq,sk,d", [
    pytest.param(300, 70, 64, id="300-70"), pytest.param(70, 300, 64, id="70-300"),
    pytest.param(300, 70, 40, id="300-70-d40"), pytest.param(70, 300, 40, id="70-300-d40")])
def test_bf16_plain_passes_d64_match_float64_autograd(sq, sk, d):
    """The yardstick the card holds the sm90 kernels to: the bf16 plain
    passes at d = 40 and 64, from K3's plain residuals and ``di`` as the
    wrapper takes them, against float64 autograd of the materialized
    attention on the same bf16 values; at the ragged lengths chip_smoke
    checks (a part tile of queries and of keys, more queries than keys and
    fewer)."""
    scale = d ** -0.5
    q, k, v, do = _operands(sq, sk, sq + 3 * sk, d)
    o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    dq = K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)
    assert dq.dtype == dk.dtype == dv.dtype == TB
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape

    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1) @ v64
    want = torch.autograd.grad(out, (q64, k64, v64), do.double())
    errs = {name: _rel(got.float(), w) for name, got, w in
            zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    print(f"\nK4 bf16 d={d} plain vs float64 autograd, Sq={sq} Sk={sk}: {errs}")
    assert max(errs.values()) <= KERNEL_TOL, errs


def test_wrappers_take_the_plain_passes_on_the_cpu():
    """On CPU tensors the bf16 wrappers run the plain passes and count no
    launch, at both head dims."""
    for d in (40, 64):
        scale = d ** -0.5
        q, k, v, do = _operands(130, 200, 11, d)
        o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
        di = (o.float() * do.float()).sum(dim=-1)
        before = (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
                  dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
                  flash_bwd.flash_attention_bwd_dkv.bf16_launches,
                  flash_bwd.flash_attention_bwd_dq.bf16_launches)
        got = K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
        want = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), d
        assert torch.equal(K.flash_attention_bwd_dq(q, k, v, do, l, m, di, scale),
                           K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)), d
        assert before == (dict(flash_bwd.flash_attention_bwd_dkv.by_head_dim),
                          dict(flash_bwd.flash_attention_bwd_dq.by_head_dim),
                          flash_bwd.flash_attention_bwd_dkv.bf16_launches,
                          flash_bwd.flash_attention_bwd_dq.bf16_launches), d


def test_launch_refuses_a_cpu_tensor():
    """The launch path has no fallback: it raises on anything but a CUDA
    tensor, before any library is built."""
    q, k, v, do = _operands(70, 70, 5)
    o, l, m = K.flash_attention_residuals_plain(q, k, v, 0.125)
    di = (o.float() * do.float()).sum(dim=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_bwd._launch(flash_bwd.flash_attention_bwd_dq, "dq",
                          (q, k, v, do, l, m, di), (torch.empty_like(q),), 0.125)
