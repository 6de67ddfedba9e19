#!/usr/bin/env python3
"""K4 at SD-1.4's head dim (40) from another checkout's
``p2p_tpu_torch/csrc/flash_attn_bwd.cu`` against this checkout's, on the
card: both libraries' C entries on the same inputs at (1, 8, 4096, 40), f32
and bf16, dq, dk and dv compared bit for bit, and both passes timed in
turns (other, this, this, other).

    python tools/k4_compare.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of this repository, e.g. the
parent commit unpacked by ``git archive``. Its source is built with this
checkout's ``nvcc`` flags into ``build/p2p_tpu_torch/``. Exits 1 if the
outputs differ. Needs one CUDA card.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash_bwd  # noqa: E402

SHAPE = (1, 8, 4096, 40)


def other_library(checkout: str) -> ctypes.CDLL:
    """The other checkout's K4 library, built here, with the entries' types."""
    out = build.BUILD_DIR / "libflash_attn_bwd-other.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(out),
                    os.path.join(checkout, "p2p_tpu_torch/csrc/flash_attn_bwd.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for sfx in ("", "_bf16"):
        dkv = getattr(lib, "p2p_flash_attn_bwd_dkv" + sfx)
        dq = getattr(lib, "p2p_flash_attn_bwd_dq" + sfx)
        dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        dkv.restype = dq.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device is visible", file=sys.stderr)
        return 2
    libs = {"other": other_library(argv[1]), "this": flash_bwd._lib()}
    print(cs.card_line())
    b, h, s, d = SHAPE
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        q, k, v, do = (torch.randn(SHAPE, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        stream = torch.cuda.current_stream().cuda_stream

        def passes(name):
            lib = libs[name]
            dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
            for entry, outs in (("p2p_flash_attn_bwd_dkv", (dk, dv)),
                                ("p2p_flash_attn_bwd_dq", (dq,))):
                status = getattr(lib, entry + sfx)(
                    *(t.data_ptr() for t in (q, k, v, do, m, l, di, *outs)),
                    b * h, s, s, d, scale, stream)
                build.check(libs["this"], status, f"{name} {entry}{sfx}")
            return dq, dk, dv

        same = all(torch.equal(x, y) for x, y in zip(passes("other"), passes("this")))
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            times[name].append(cs.cuda_ms(torch, lambda: passes(name), 50))
        print(f"K4 d=40 {dtype} {SHAPE}: dq, dk, dv bitwise equal to the other "
              f"checkout's: {same}; dkv + dq ms, other {times['other']}, this "
              f"{times['this']}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
