#!/usr/bin/env python3
"""``flash_fwd_sm90_kernel<40>`` (``csrc/flash_fwd_sm90.cu``, K1 and K3 in
bf16 at d = 40) against the variants of its design that were timed and
left out, on the card, on the same inputs, in turns.

    python tools/k1_d40_variants.py

Each variant is a text edit of this checkout's source, written with its
library into ``build/p2p_tpu_torch/variants/`` (never into ``csrc/``, whose
sources the package builds) and built with the package's ``nvcc`` flags and
``-I csrc`` for its includes. The edits are of the source as this design
left it: a later change to the lines they replace makes the tool stop with
the edit that no longer applies, and the variant is then retired, not
patched:

- ``filled``: K and V land in zero-filled 64-column boxes, as Q does, and
  their barriers expect the whole box (the landing of the sm90 K4 passes);
- ``n64``: P·V by m64n64k16 over all 64 columns of V's tile, O in 32
  registers;
- ``two_stages``: two K and two V stages, as at d = 64;
- ``n64_two_stages``: both of the last two;
- ``first``: all three, the kernel as first written;
- ``padded``: no edit: this library's d = 64 instance on copies of q, k and
  v zero-padded to 64 columns (what the d = 40 instance would take were the
  rows 128 bytes apart).

Shapes: K1 at (4, 8, 4096, 40) and (1, 8, 4096, 40), K3 at (1, 8, 4096, 40)
(SD-1.4's 64² self sites in a bf16 edit, a bf16 inversion's forwards and
its gradients). Every variant's output (and ``m``, ``l``) must be bit for
bit this kernel's: they change where data lands and in what order the
same products run, not the arithmetic. Each is timed beside this kernel
and SDPA in bf16, in the order listed and back, twice. Prints the card
and each shape's times; writes ``chiprun_out/k1_d40_variants.json``. Exits
1 if an output differs. Needs one CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash  # noqa: E402

SHAPES = (((4, 8, 4096, 40), False), ((1, 8, 4096, 40), False), ((1, 8, 4096, 40), True))

FILLED = [("encode_rows(fn, &tk, k, D, sk, bh, k_box, D < 64)",
           "encode_rows(fn, &tk, k, D, sk, bh, k_box)"),
          ("encode_rows(fn, &tv, v, D, sk, bh, v_box, D < 64)",
           "encode_rows(fn, &tv, v, D, sk, bh, v_box)"),
          ("constexpr int KV_BYTES = BN * DH * 2;", "constexpr int KV_BYTES = TILE_BYTES;")]
N64 = [("float acc[DH / 2];", "float acc[32];"),
       ("for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;",
        "for (int i = 0; i < 32; ++i) acc[i] = 0.f;"),
       ("for (int i = 0; i < DH / 2; ++i) acc[i] *= cf[(i >> 1) & 1];",
        "for (int i = 0; i < 32; ++i) acc[i] *= cf[(i >> 1) & 1];"),
       ("if constexpr (DH == 40)\n          wgmma_rs_n40(acc, pk + 4 * ks, db + 128 * ks);\n"
        "        else\n          wgmma_rs_n64(", "wgmma_rs_n64(")]
TWO_STAGES = [("return DH < BOX ? 3 : 2;", "return 2;")]
VARIANTS = {"filled": FILLED, "n64": N64, "two_stages": TWO_STAGES,
            "n64_two_stages": N64 + TWO_STAGES, "first": FILLED + N64 + TWO_STAGES}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


VARIANT_DIR = build.BUILD_DIR / "variants"


def build_variants() -> dict:
    """``{name: forward entry}`` of this library and each variant's."""
    src = (build.CSRC / "flash_fwd_sm90.cu").read_text()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        path = VARIANT_DIR / f"flash_fwd_sm90_{name}.cu"
        path.write_text(edited(src, edits))
        out = VARIANT_DIR / f"libflash_fwd_sm90_{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, f"-I{build.CSRC}",
             "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    entries = {"this": flash.forward_entry("p2p_flash_attn_fwd_bf16_sm90")}
    for name, (proc, out) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{text}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in text.splitlines()
                if "Used" in line and "registers" in line]
        print(f"variant {name}: built; registers of its kernels {regs}")
        lib = ctypes.CDLL(str(out))
        fn = lib.p2p_flash_attn_fwd_bf16_sm90
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = (lib, fn)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_d40_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    entries = build_variants()
    names = ["this", *VARIANTS, "padded"]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(40)
    bad, rows = [], []
    for shape, k3 in SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        padded = [torch.nn.functional.pad(t, (0, 64 - d)).contiguous() for t in (q, k, v)]
        bufs = {}
        for name in names:
            o = torch.empty((b, h, s, 64 if name == "padded" else d), device="cuda",
                            dtype=torch.bfloat16)
            ml = [torch.empty((b, h, s), device="cuda") for _ in range(2)] if k3 else [None] * 2
            bufs[name] = (o, *ml)

        def call(name):
            lib, fn = entries["this" if name == "padded" else name]
            qq, kk, vv = padded if name == "padded" else (q, k, v)
            o, m, l = bufs[name]
            status = fn(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(),
                        None if m is None else m.data_ptr(),
                        None if l is None else l.data_ptr(), None, 1, b * h, s, s,
                        qq.shape[-1], d ** -0.5, stream)
            build.check(lib, status, f"{name} forward")

        for name in names:
            call(name)
        torch.cuda.synchronize()
        tag = f"{'K3' if k3 else 'K1'} {shape}"
        want = K.flash_attention_residuals_plain(q, k, v, d ** -0.5)[0]
        err = cs.max_err(torch, bufs["this"][0], want) / want.double().abs().max().item()
        if err > cs.BF16_TOL:
            bad.append(f"{tag}: {err:.3g} of the largest magnitude from the plain version")
        for name in names[1:]:
            o, m, l = bufs[name]
            same = torch.equal(o[..., :d], bufs["this"][0]) and (
                not k3 or (torch.equal(m, bufs["this"][1]) and torch.equal(l, bufs["this"][2])))
            if not same:
                bad.append(f"{tag} {name}: not bit for bit this kernel's")
        times = {name: [] for name in names}
        for name in (names + names[::-1]) * 2:
            times[name].append(cs.cuda_ms(torch, lambda: call(name), 20))
        sdpa = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5), 20)
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        rows.append({"shape": list(shape), "k3": k3, "max_rel_err_vs_plain": err,
                     "ms": times, "mean_ms": mean, "sdpa_bf16_ms": sdpa,
                     "over_this": {n: mean[n] / mean["this"] for n in names}})
        print(f"{tag}: err {err:.3g}; sdpa bf16 {sdpa:.4f} ms; " + "; ".join(
            f"{n} {mean[n]:.4f} ms ({mean[n] / mean['this']:.3f}x)" for n in names))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k1_d40_variants.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "failures": bad}, f, indent=1)
    for line in bad:
        print("FAIL", line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
