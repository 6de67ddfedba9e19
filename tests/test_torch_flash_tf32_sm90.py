"""K1 and K3 in f32 at d = 64 as ``flash_fwd_tf32_sm90_kernel`` computes them
(``p2p_tpu_torch/csrc/flash_fwd_tf32_sm90.cu``: 3xTF32 on tf32 wgmma, tiles
landed by TMA, 128 query rows a block, 64 keys a tile, K and V split into
their hi and lo parts once a call by ``flash_split_kv_tf32_kernel``), on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there, within 1e-5). Here the wrapper's routing of f32 at
d = 64 to the new entry (and of d = 40 and 512 to ``csrc/flash_attn.cu``)
is checked by name, the source by the instructions it is written on, and
the kernel's arithmetic by its plain emulation (``kernels.tf32.flash_d40``
at the kernel's key tile: the 3xTF32 products tile by tile, the online
softmax in base 2, each tile's P·V added in f32) against the plain
versions, float64 and the JAX package's Pallas flash kernel under the
interpreter.
"""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from p2p_tpu.kernels import force_tpu_interpret_mode  # noqa: E402
from p2p_tpu.models import nn as jnn  # noqa: E402

from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash, tf32  # noqa: E402

D = 64
SCALE = D ** -0.5
SOURCE = "flash_fwd_tf32_sm90"
ENTRY = "p2p_flash_attn_fwd_f32_sm90"
TC_TOL = 1e-5    # f32 outputs of the largest magnitude; K3's m and l relative


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkv(sq, sk, seed):
    """f32 q (1, 2, sq, 64) and k, v (1, 2, sk, 64) from numpy."""
    rng = np.random.RandomState(seed)
    q = rng.randn(1, 2, sq, D).astype(np.float32)
    k, v = (rng.randn(1, 2, sk, D).astype(np.float32) for _ in range(2))
    return q, k, v


def _float64(q, k, v):
    """``(out, l, m)`` of the materialized attention in float64."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * SCALE
    m = s.max(axis=-1)
    p = np.exp(s - m[..., None])
    l = p.sum(axis=-1)
    return np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64)) / l[..., None], l, m


@pytest.mark.parametrize("dtype,d,entry,library", [
    pytest.param(torch.float32, 64, ENTRY, SOURCE, id="f32-64"),
    pytest.param(torch.float32, 40, "p2p_flash_attn_fwd", "flash_attn", id="f32-40"),
    pytest.param(torch.float32, 512, "p2p_flash_attn_fwd", "flash_attn", id="f32-512"),
])
def test_forward_entry_by_dtype_and_head_dim(dtype, d, entry, library):
    """f32 at d = 64 runs the new kernel; f32 at d = 40 and 512 stays on
    ``flash_attn.cu``; each entry lives in the library the wrapper builds
    for it, and the package builds that library."""
    assert flash.entry_for(dtype, d) == entry
    assert flash.ENTRIES[entry] == library
    assert library in build.sources()
    src = (build.CSRC / f"{library}.cu").read_text()
    assert f'extern "C" int {entry}(' in src


def test_source_runs_on_tf32_wgmma_and_tma():
    """The kernel is written on Hopper's instructions (its source and the
    header of them it includes): tf32 wgmma, TMA on mbarriers, f32 tensor
    maps in 32-column boxes; no mma.sync; and the parent's ``mma.sync``
    kernel has left ``flash_attn.cu``, whose d = 64 case names the new
    library."""
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    assert '#include "sm90.cuh"' in src
    text = src + (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                   "cp.async.bulk.tensor.3d", "mbarrier.try_wait",
                   "mbarrier.arrive.expect_tx", "fence.proxy.async",
                   "CU_TENSOR_MAP_DATA_TYPE_FLOAT32", "CU_TENSOR_MAP_SWIZZLE_128B",
                   "__grid_constant__"):
        assert needle in text, needle
    assert not re.search(r"wgmma\.mma_async\S*\.tf32\.tf32[^;]*, 1, 1, [01]", text), \
        "tf32 wgmma takes no transpose operands"
    for call in ("flash_fwd_tf32_sm90_kernel(", "flash_split_kv_tf32_kernel(",
                 "wgmma_rs_tf32_n64(", "tma_load_col(", "mbar_wait(", "encode_rows_f32(",
                 "split_tf32(", "exp2_ftz("):
        assert call in src, call
    # The wrapper sizes the split pass's scratch by the library's own count.
    assert 'extern "C" long long p2p_flash_attn_fwd_f32_sm90_scratch(' in src
    assert "p2p_flash_attn_fwd_f32_sm90_scratch" in (build.CSRC.parent / "kernels"
                                                      / "flash.py").read_text()
    assert "mma.sync" not in text
    old = (build.CSRC / "flash_attn.cu").read_text()
    for gone in ("flash_d64_kernel", "launch_d64", "namespace d64"):
        assert gone not in old, gone
    assert "flash_fwd_tf32_sm90" in old
    for path in build.CSRC.glob("*.cu"):
        assert "flash_d64_kernel" not in path.read_text(), path


def test_emulation_steps_at_the_kernel_key_tile():
    """``tf32.flash_d40`` emulates the kernel only while its step is the
    kernel's key tile."""
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    tile = re.search(r"constexpr int BN = (\d+);", src)
    assert tile is not None and int(tile.group(1)) == tf32.D40_STEP == 64


@pytest.mark.parametrize("sq,sk", [
    pytest.param(512, 512, id="512"), pytest.param(300, 70, id="300-70"),
    pytest.param(70, 300, id="70-300"), pytest.param(130, 200, id="130-200")])
def test_emulation_matches_plain_and_float64(sq, sk):
    """The kernel's arithmetic (3xTF32 products over 64-key tiles, the
    softmax in base 2, each tile's P·V added in f32) within ``TC_TOL`` of
    the plain versions, the card's yardstick, and of float64: K1's output
    of the largest magnitude, K3's ``m`` and ``l`` relative; at a whole
    number of tiles and at the ragged lengths chip_smoke checks (one part
    tile of keys, a query tile past Sq)."""
    q, k, v = _qkv(sq, sk, sq + 7 * sk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tf32.flash_d40(tq, tk, tv, SCALE)
    plain = K.flash_attention_residuals_plain(tq, tk, tv, SCALE)
    exact = _float64(q, k, v)
    assert all(t.dtype == torch.float32 for t in got)
    assert got[0].shape == (1, 2, sq, D) and got[1].shape == got[2].shape == (1, 2, sq)
    errs = {}
    for name, g, p, x in zip(("out", "l", "m"), got, plain, exact):
        errs[f"{name} vs plain"] = _rel(g, p)
        errs[f"{name} vs float64"] = _rel(g, x)
        errs[f"{name} plain vs float64"] = _rel(p, x)
    print(f"\nK1/K3 f32 d=64 tiles vs plain and float64, Sq={sq} Sk={sk}: {errs}")
    assert max(errs.values()) <= TC_TOL, errs


def test_one_tf32_product_fails_the_bar():
    """The bar has teeth: the same tiles with one TF32 product a term
    (``mm_1xtf32``) miss ``TC_TOL`` of float64."""
    q, k, v = _qkv(256, 256, 3)
    got = tf32.flash_d40(*(torch.from_numpy(a) for a in (q, k, v)), SCALE,
                         mm=tf32.mm_1xtf32)
    assert _rel(got[0], _float64(q, k, v)[0]) > 10 * TC_TOL


def test_emulation_and_plain_match_pallas():
    """The emulation and the plain versions within ``TC_TOL`` of the JAX
    package's K1 and K3 (``flash_attention_tpu``, ``flash_attention_residuals``:
    the Pallas flash kernel under the interpreter, blocks of 128) on the
    same numpy inputs at (1, 2, 512, 64): outputs of the largest magnitude,
    ``l`` and ``m`` relative."""
    q, k, v = _qkv(512, 512, 20)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    with force_tpu_interpret_mode():
        want1 = np.asarray(jnn.flash_attention_tpu(jq, jk, jv, SCALE, 128))
        want3 = [np.asarray(a) for a in jnn.flash_attention_residuals(jq, jk, jv, SCALE, 128)]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    emulated = tf32.flash_d40(tq, tk, tv, SCALE)
    plain1 = K.flash_attention_plain(tq, tk, tv, SCALE)
    plain3 = K.flash_attention_residuals_plain(tq, tk, tv, SCALE)
    errs = {"K1 emulation": _rel(emulated[0], want1), "K1 plain": _rel(plain1, want1)}
    for name, e, p, w in zip(("out", "l", "m"), emulated, plain3, want3):
        errs[f"K3 {name} emulation"] = _rel(e, w)
        errs[f"K3 {name} plain"] = _rel(p, w)
    print(f"\nK1/K3 f32 d=64 vs Pallas (blocks of 128): {errs}")
    assert max(errs.values()) <= TC_TOL, errs


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the f32 wrappers at d = 64 run the plain versions and
    count no launch; the launch path itself refuses a CPU tensor before any
    library is built."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(130, 70, 11))
    before = (dict(flash.flash_attention.by_head_dim),
              dict(flash.flash_attention_residuals.by_head_dim), K.split_launches())
    assert torch.equal(K.flash_attention(q, k, v, SCALE), K.flash_attention_plain(q, k, v, SCALE))
    assert all(torch.equal(a, b) for a, b in zip(
        K.flash_attention_residuals(q, k, v, SCALE),
        K.flash_attention_residuals_plain(q, k, v, SCALE)))
    assert before == (dict(flash.flash_attention.by_head_dim),
                      dict(flash.flash_attention_residuals.by_head_dim), K.split_launches())
    with pytest.raises(ValueError, match="unsupported device"):
        flash._launch("flash_attention", q, k, v, SCALE, residuals=False)


@pytest.mark.parametrize("name", [
    pytest.param("void (anonymous namespace)::flash_fwd_tf32_sm90_kernel(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, float *, float *, float *, int, int, float)",
                 id="forward"),
    pytest.param("void (anonymous namespace)::flash_split_kv_tf32_kernel(const float *, "
                 "const float *, float *, float *, int)", id="split")])
def test_profile_step_counts_both_kernels_as_k1(name):
    """``profile_step``'s breakdown puts the forward and its split pass in
    K1/K3's class."""
    from p2p_tpu_torch import profile_step

    assert profile_step._class(name) == "K1/K3 flash_attn"


def test_split_passes_count_apart_and_reset():
    """The split pass counts in ``<wrapper>.split_launches``, summed by
    ``kernels.split_launches`` and zeroed with the other counts."""
    flash.flash_attention.split_launches += 2
    flash.flash_attention_residuals.split_launches += 3
    assert K.split_launches() >= 5
    K.reset_launch_counts()
    assert K.split_launches() == 0 == K.merge_launches()


def test_chip_smoke_checks_the_new_library():
    """``chip_smoke.py`` checks the new library's SASS and ptxas report
    (``SM90_LIBRARIES``) and knows its kernel by the name ptxas prints."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  build.CSRC.parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.SM90_LIBRARIES[SOURCE] == ("flash_fwd_tf32_sm90_kernel",)
    assert cs.SM90_PLAIN_KERNELS[SOURCE] == ("flash_split_kv_tf32_kernel",)
    for kernel in ("flash_fwd_tf32_sm90_kernel", "flash_split_kv_tf32_kernel"):
        mangled = f"_ZN55_GLOBAL__N__flash_fwd_tf32_sm90_cu_1a2b3c4d26{kernel}E14CUtensorMap_st"
        assert cs.kernel_instance(mangled) == kernel
    # One split pass before each f32 d = 64 call, K1's and K3's.
    assert cs.split_passes({"K1 f32 d=64": 500, "K3 f32 d=64": 4500, "K1 bf16 d=64": 7,
                            "K1 f32 d=512": 2}) == 5000
    assert cs.split_passes({"K1 bf16 d=64": 250}) == 0
    assert math.isclose(cs.bound(4.0 * 4 * 5 * 9216 ** 2 * D, 0, True)["bound_ms"], 2.6355,
                        rel_tol=1e-4)
