"""K1 and K3 in bf16 at d = 40 as ``flash_fwd_sm90_kernel<40>`` computes
them (``p2p_tpu_torch/csrc/flash_fwd_sm90.cu``: the d = 64 design on wgmma
and TMA, templated on the head dim, each 40-column row landed by TMA in the
64-column swizzled layout, 128 keys a tile), against the JAX package, on
the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there). Here its arithmetic, ``kernels.bf16.flash`` at the
kernel's key tile (``kernels.bf16.K1_STEP`` = 128: each tile's
unnormalized P is rounded to bf16 before P·V, and ``s·scale2 − m2`` is one
fused multiply-add), is held against the Pallas flash kernel under the
interpreter at (1, 2, 512, 40) in blocks of 128 (output within 1e-2 of the
largest magnitude, K3's ``l`` and ``m`` within 1e-5 relative, the bars of
``tests/test_torch_flash_sm90.py``), and against the plain version at
ragged lengths. Then the wrapper's routing of bf16 at d = 40 to the sm90
entry, the source (the template's instances, its k16 steps, the landing,
the old ``mma.sync`` forward gone), and the names ``profile_step.py`` and
``chip_smoke.py`` know it by.
"""

import importlib.util
import re

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
D = 40
SCALE = D ** -0.5
KERNEL_TOL = 1e-2      # bf16 outputs, of the largest magnitude
STATS_TOL = 1e-5       # K3's f32 m and l, relative
# The kernel's symbol as the profiler and as ptxas / cuobjdump print it.
DEMANGLED = ("void (anonymous namespace)::flash_fwd_sm90_kernel<40>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 *, float *, float *, int, int, "
             "float)")
MANGLED = ("_ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi40EEEv14CUtensorMap_stS1_S1_"
           "P13__nv_bfloat16PfS4_iif")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(rng, shape):
    """A bf16 array from numpy, as JAX and as torch."""
    j = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TB)


def _source() -> str:
    return (build.CSRC / "flash_fwd_sm90.cu").read_text()


def test_k1_k3_d40_bf16_emulation_at_the_kernel_tile_matches_pallas():
    rng = np.random.RandomState(19)
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
    print(f"\nd = 40 sm90 tile emulation vs Pallas (blocks of 128): {errs}")
    assert errs["K1"] <= KERNEL_TOL and errs["K3 out"] <= KERNEL_TOL, errs
    assert errs["l"] <= STATS_TOL and errs["m"] <= STATS_TOL, errs
    # The tile moves where P rounds: the mma.sync kernel's 64-key steps
    # rounded elsewhere, within the same bar.
    out64 = kbf16.flash(q, k, v, SCALE, step=64)
    assert not torch.equal(out64, out)
    assert _rel(out64.to(TB).float(), want1) <= KERNEL_TOL


@pytest.mark.parametrize("sq,sk", [pytest.param(300, 70, id="300-70"),
                                   pytest.param(1000, 1000, id="1000-1000")])
def test_k1_k3_d40_bf16_emulation_ragged_matches_plain(sq, sk):
    """A query tile past Sq and a key tile past Sk (70 keys: one part-full
    tile; 1000: seven full tiles and one of 104)."""
    g = torch.Generator().manual_seed(sq + 5 * sk)
    q = torch.randn((1, 2, sq, D), generator=g).to(TB)
    k, v = (torch.randn((1, 2, sk, D), generator=g).to(TB) for _ in range(2))
    out, l, m = kbf16.flash(q, k, v, SCALE, residuals=True)
    p_out, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, SCALE)
    assert _rel(out.to(TB).float(), p_out.float()) <= KERNEL_TOL
    assert _rel(l, p_l) <= STATS_TOL and _rel(m, p_m) <= STATS_TOL
    # On the CPU the wrappers run the plain versions, bit for bit.
    assert torch.equal(K.flash_attention(q, k, v, SCALE),
                       K.flash_attention_plain(q, k, v, SCALE))
    assert all(torch.equal(a, b) for a, b in zip(
        K.flash_attention_residuals(q, k, v, SCALE), (p_out, p_l, p_m)))


def test_launch_refuses_a_cpu_tensor():
    """The launch path takes CUDA tensors only: a CPU tensor never reaches
    a kernel, and nothing falls back to the plain version there."""
    q = torch.zeros((1, 1, 128, D), dtype=TB)
    with pytest.raises(ValueError, match="unsupported device"):
        flash._launch("flash_attention", q, q, q, SCALE, residuals=False)


def test_bf16_d40_routes_to_the_sm90_entry():
    entry = flash.entry_for(TB, D)
    assert entry == "p2p_flash_attn_fwd_bf16_sm90"
    assert flash.ENTRIES[entry] == "flash_fwd_sm90"
    assert "p2p_flash_attn_fwd_bf16" not in flash.ENTRIES
    assert all(flash.entry_for(TB, d) == entry for d in flash.SUPPORTED_HEAD_DIMS_BF16)
    assert flash.entry_for(torch.float32, D) == "p2p_flash_attn_fwd"


def test_sm90_forward_is_one_template_at_d40_and_d64():
    """One kernel template on the head dim, instantiated at 40 and 64; its
    Q·Kᵀ k16 steps round up (3 at d = 40); the tensor maps take the head dim:
    Q lands in a zero-filled 64-column box, whose bytes its barrier expects
    whole, K and V below d = 64 in narrow boxes of their own columns, whose
    bytes theirs expect, into a K ring zeroed first (the third k16 step
    reads K's columns 40..47 against Q's zeros); P·V is m64n40k16 at d = 40
    with three K and V stages; the store writes DH columns at a row stride
    of DH; the entry refuses any other head dim but 512."""
    src = _source()
    assert re.search(r"template <int DH>\n__global__ void __launch_bounds__\(fwd::NT, 1\)\n"
                     r"flash_fwd_sm90_kernel\(", src)
    assert sorted(set(re.findall(r"launch_fwd<(\d+)>", src))) == ["40", "64"]
    assert "return (DH + 15) / 16;" in src
    assert "qk_steps<40>() == 3 && qk_steps<64>() == 4" in src
    assert "constexpr int KS = qk_steps<DH>();" in src
    assert "for (int ks = 0; ks < KS; ++ks) wgmma_ss_n128(" in src
    assert "ks < D / 16" not in src
    assert "encode_qkv<DH>(tq, tk, tv, q, k, v, bh, sq, sk, ROWS, BN, BN)" in src
    assert len(re.findall(r"encode_rows\(fn, &t[qkv], [qkv], D,", src)) == 3
    assert "constexpr int ROW_BYTES = BOX * 2;" in src
    assert "constexpr int KV_BYTES = BN * DH * 2;" in src
    for barrier in ("bar_q, Q_BYTES", "k_full(s), KV_BYTES", "v_full(s), KV_BYTES"):
        assert f"mbar_expect_tx({barrier});" in src, barrier
    for t, rows in (("k", "k_box"), ("v", "v_box")):
        assert f"encode_rows(fn, &t{t}, {t}, D, sk, bh, {rows}, D < 64)" in src, t
    assert "encode_rows(fn, &tq, q, D, sq, bh, q_box) &&" in src
    header = (build.CSRC / "sm90.cuh").read_text()
    assert re.search(r"int bh, int box_rows, bool narrow = false\)", header)
    assert "if (narrow) box[0] = d;" in header
    zeroing = src[src.index("if constexpr (DH < BOX) {"):src.index("fence_proxy_async();")]
    assert "i < STAGES * TILE_BYTES / 16" in zeroing and "k_s + 16 * i" in zeroing
    assert "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16" in header
    assert "if constexpr (DH == 40)\n          wgmma_rs_n40(acc," in src
    assert "float acc[DH / 2];" in src
    assert "return DH < BOX ? 3 : 2;" in src
    assert "o + (head + r) * DH" in src and "n < DH / 8" in src
    assert "(d != 40 && d != 64) || nsplit != 1 || part != nullptr" in src
    # The scale folds into the exponent's one fused multiply-add, at both
    # head dims (kernels.bf16.flash rounds it once).
    assert "exp2_ftz(fmaf(sc[i], scale2, -m2[h]))" in src


def test_mma_sync_bf16_forward_is_gone_and_k2_keeps_its_header():
    src = _source()
    assert "mma.sync" not in src
    assert "flash_d64_sm90_kernel" not in src
    for path in build.CSRC.glob("*.cu"):
        text = path.read_text()
        assert "flash_d40_bf16_kernel" not in text, path
        assert "p2p_flash_attn_fwd_bf16(" not in text, path
        assert "namespace d40bf" not in text, path
    fused = (build.CSRC / "fused_edit.cu").read_text()
    assert '#include "attn_bf16.cuh"' in fused
    assert "attend_bf16<D, TileBf16<D>::BS, WARPS, true>(" in fused
    assert (build.CSRC / "attn_bf16.cuh").exists()


def test_profile_step_counts_the_d40_kernel_as_k1():
    from p2p_tpu_torch import profile_step

    assert profile_step._class(DEMANGLED) == "K1/K3 flash_attn"
    assert profile_step._class(DEMANGLED.replace("<40>", "<64>")) == "K1/K3 flash_attn"


def test_chip_smoke_checks_both_instances():
    """``chip_smoke.py`` expects both instances in the library's SASS and
    ptxas report, and reads them from the mangled symbol."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  build.CSRC.parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.SM90_LIBRARIES["flash_fwd_sm90"]) == {
        "flash_fwd_sm90_kernel<40>", "flash_fwd_sm90_kernel<64>", "flash_d512_sm90_kernel"}
    assert cs.kernel_instance(MANGLED) == "flash_fwd_sm90_kernel<40>"
    assert cs.kernel_instance(DEMANGLED) == "flash_fwd_sm90_kernel<40>"


def test_variant_tool_writes_outside_the_sources_and_imports_no_jax():
    """``tools/k1_d40_variants.py`` times the left-out designs as text edits
    of the kernel's source: it writes its copies under the build directory,
    never beside the sources the package builds, stops on an edit that does
    not match exactly once, and, like ``tools/k1_compare.py``, runs without
    JAX."""
    root = build.CSRC.parents[1]
    spec = importlib.util.spec_from_file_location("k1_d40_variants",
                                                  root / "tools" / "k1_d40_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.VARIANT_DIR.is_relative_to(build.BUILD_DIR)
    assert not tool.VARIANT_DIR.is_relative_to(build.CSRC)
    assert tool.edited("a b c", [("b", "x")]) == "a x c"
    assert tool.edited("a b", [("a", "x"), ("x", "y")]) == "y b"   # in order
    for edits in ([("d", "x")], [(" ", "_")]):                      # none, two
        with pytest.raises(RuntimeError, match="does not apply"):
            tool.edited("a b c", edits)
    for name in ("k1_d40_variants.py", "k1_compare.py"):
        text = (root / "tools" / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|p2p_tpu)\b(?!_torch)", text, re.M), name
