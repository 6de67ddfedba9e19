#!/usr/bin/env python3
"""K4 from another checkout against this checkout's, on the card, on the
same inputs, each pass timed in turns (other, this, this, other):

- f32 at d = 40 (SD-1.4's gradient sites, (1, 8, 4096, 40)) and at d = 64
  (SD-2.1's three, (1, 5, 9216, 64), (1, 10, 2304, 64) and
  (1, 5, 4096, 64)): both checkouts' ``csrc/flash_attn_bwd.cu``, dq, dk
  and dv bit for bit;
- bf16 at the same four sites: the other checkout's entry for it (its
  ``csrc/flash_attn_bwd.cu`` bf16 entry where that has one and, at d = 64,
  no ``csrc/flash_bwd_sm90.cu`` stands beside it; else its sm90 entry)
  against this checkout's route (``kernels.flash_bwd.entry_for``): dq, dk
  and dv bit for bit where both checkouts run the entry of the same name,
  else within ``BF16_TOL`` of each other's and of the plain passes' largest
  magnitude (their tiles differ), each bitwise across two launches; SDPA's
  backward alone beside them, eager and as a replayed CUDA graph;
- the host's µs a call of the bf16 d = 64 passes at a shape whose device
  time is short, (1, 2, 300, 64) with Sk = 70: C entry against C entry,
  and wrapper against wrapper (each checkout's in a process of its own)
  when OTHER_CHECKOUT holds the whole package.

    python tools/k4_compare.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of this repository, e.g. the
parent commit unpacked by ``git archive``. Its sources are built with this
checkout's ``nvcc`` flags into ``build/p2p_tpu_torch/``. Writes
``chiprun_out/k4_compare.json``; exits 1 if an output is out of its bar.
Needs one CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from p2p_tpu_torch import kernels as K  # noqa: E402
from p2p_tpu_torch.kernels import build, flash_bwd  # noqa: E402

SITES = ((1, 8, 4096, 40), (1, 5, 9216, 64), (1, 10, 2304, 64), (1, 5, 4096, 64))
HOST_SHAPE = (1, 2, 300, 64)   # and Sk = 70: the host, not the device, sets the pace
HOST_CALLS = 2000
# A checkout's K4 wrappers in bf16 at d = 64, host µs a call of both passes
# at HOST_SHAPE, in a process of its own (argv: checkout, calls); prints
# the figure last.
WRAPPER_TIMING = r"""
import sys, time, torch
sys.path.insert(0, sys.argv[1])
from p2p_tpu_torch import kernels as K
g = torch.Generator("cuda").manual_seed(0)
q, do = (torch.randn((1, 2, 300, 64), generator=g, device="cuda").to(torch.bfloat16)
         for _ in range(2))
k, v = (torch.randn((1, 2, 70, 64), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(2))
o, l, m = K.flash_attention_residuals_plain(q, k, v, 0.125)
di = (o.float() * do.float()).sum(-1)
def call():
    K.flash_attention_bwd_dkv(q, k, v, do, l, m, di, 0.125)
    K.flash_attention_bwd_dq(q, k, v, do, l, m, di, 0.125)
for _ in range(50):
    call()
torch.cuda.synchronize()
n = int(sys.argv[2])
t0 = time.perf_counter()
for _ in range(n):
    call()
print((time.perf_counter() - t0) / n * 1e6)
torch.cuda.synchronize()
"""


def wrapper_us(checkout: str) -> float:
    """Host µs a call of ``checkout``'s two K4 wrappers in bf16 at d = 64
    (it builds its own libraries on first use)."""
    out = subprocess.run([sys.executable, "-c", WRAPPER_TIMING, checkout, str(HOST_CALLS)],
                         cwd=checkout, capture_output=True, text=True, check=True)
    return float(out.stdout.split()[-1])


def other_entries(checkout: str):
    """``{(pass, dtype, d): (library, function)}`` of the other checkout,
    built here: its ``flash_attn_bwd.cu`` entries and, for bf16, its
    ``flash_bwd_sm90.cu`` ones where it has that source, except at d = 40
    where its ``flash_attn_bwd.cu`` still has a bf16 entry."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("flash_attn_bwd", "flash_bwd_sm90"):
        src = os.path.join(checkout, "p2p_tpu_torch", "csrc", f"{name}.cu")
        if not os.path.exists(src):
            continue
        out = build.BUILD_DIR / f"lib{name}-other.so"
        subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(out))
    found = {}
    for p in ("dkv", "dq"):
        for dtype, d in ((torch.float32, 40), (torch.bfloat16, 40), (torch.float32, 64),
                         (torch.bfloat16, 64)):
            sfx = "" if dtype == torch.float32 else "_bf16"
            lib = libs["flash_attn_bwd"]
            if dtype == torch.bfloat16 and "flash_bwd_sm90" in libs and (
                    d == 64 or not hasattr(lib, f"p2p_flash_attn_bwd_{p}_bf16")):
                lib, sfx = libs["flash_bwd_sm90"], "_bf16_sm90"
            fn = getattr(lib, f"p2p_flash_attn_bwd_{p}{sfx}")
            fn.argtypes = [ctypes.c_void_p] * (9 if p == "dkv" else 8) + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            found[(p, dtype, d)] = (lib, fn)
    return found


def host_us(checkout: str, other) -> dict:
    """The host's µs a call of both bf16 d = 64 passes at HOST_SHAPE: the
    C entries in turns, then the wrappers, each checkout's in a process of
    its own, where the other checkout has the package."""
    b, h, sq, d = HOST_SHAPE
    sk, scale = 70, d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator("cuda").manual_seed(4)
    q, do = (torch.randn(HOST_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    fns = {"other": {p: other[(p, torch.bfloat16, d)][1] for p in ("dkv", "dq")},
           "this": {p: flash_bwd.backward_entry(flash_bwd.entry_for(p, torch.bfloat16, d))[1]
                    for p in ("dkv", "dq")}}

    def call(name):
        fns[name]["dkv"](*(t.data_ptr() for t in (q, k, v, do, m, l, di, dk, dv)),
                         b * h, sq, sk, d, scale, stream)
        fns[name]["dq"](*(t.data_ptr() for t in (q, k, v, do, m, l, di, dq)),
                        b * h, sq, sk, d, scale, stream)

    host = {}
    for key, name in (("other_entry", "other"), ("this_entry", "this"),
                      ("this_entry_2", "this"), ("other_entry_2", "other")):
        for _ in range(50):
            call(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call(name)
        host[key] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    if os.path.exists(os.path.join(checkout, "p2p_tpu_torch", "kernels", "flash_bwd.py")):
        for key, tree in (("other_wrapper", checkout), ("this_wrapper", ROOT),
                          ("this_wrapper_2", ROOT), ("other_wrapper_2", checkout)):
            host[key] = wrapper_us(tree)
    print("host µs a call of dkv + dq, bf16 at (1, 2, 300, 64), Sk = 70: " +
          ", ".join(f"{key} {us:.2f}" for key, us in host.items()), flush=True)
    return host


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device is visible", file=sys.stderr)
        return 2
    other = other_entries(argv[1])
    card = cs.card_line()
    print(card)
    gen = torch.Generator("cuda").manual_seed(3)
    bad, rows = [], []
    cases = [(s, torch.float32) for s in SITES] + [(s, torch.bfloat16) for s in SITES]
    for shape, dtype in cases:
        b, h, s, d = shape
        scale = d ** -0.5
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, l, m = K.flash_attention_residuals_plain(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        entries = {"other": {p: other[(p, dtype, d)] for p in ("dkv", "dq")},
                   "this": {p: flash_bwd.backward_entry(flash_bwd.entry_for(p, dtype, d))
                            for p in ("dkv", "dq")}}

        def passes(name, which=("dkv", "dq")):
            dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
            for p, outs in (("dkv", (dk, dv)), ("dq", (dq,))):
                if p not in which:
                    continue
                lib, fn = entries[name][p]
                status = fn(*(t.data_ptr() for t in (q, k, v, do, m, l, di, *outs)),
                            b * h, s, s, d, scale, torch.cuda.current_stream().cuda_stream)
                build.check(lib, status, f"{name} {p} {dtype} d={d}")
            return dq, dk, dv

        got = {name: passes(name) for name in ("other", "this")}
        again = passes("this")
        torch.cuda.synchronize()
        tag = f"K4 d={d} {str(dtype).split('.')[-1]} {shape}"
        row = {"shape": list(shape), "dtype": str(dtype), "entries": {
            name: [fn.__name__ for _, fn in e.values()] for name, e in entries.items()}}
        row["bitwise_equal"] = all(torch.equal(x, y) for x, y in zip(got["other"], got["this"]))
        verdict = f"bitwise equal to the other checkout's: {row['bitwise_equal']}"
        if row["entries"]["other"] == row["entries"]["this"]:
            if not row["bitwise_equal"]:
                bad.append(f"{tag}: outputs differ from the other checkout's")
        else:
            p_dk, p_dv = K.flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
            plain = (K.flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale), p_dk, p_dv)
            errs = {}
            for i, what in enumerate(("dq", "dk", "dv")):
                for key, a, ref in (("this_vs_other", got["this"][i], got["other"][i]),
                                    ("this_vs_plain", got["this"][i], plain[i]),
                                    ("other_vs_plain", got["other"][i], plain[i])):
                    e = cs.max_err(torch, a, ref) / ref.double().abs().max().item()
                    errs[f"{what} {key}"] = e
                    if e > cs.BF16_TOL:
                        bad.append(f"{tag} {what} {key}: {e:.3g} > {cs.BF16_TOL}")
            row["errors"] = errs
            verdict += "; " + ", ".join(f"{key} {e:.3g}" for key, e in errs.items())
        if not all(torch.equal(x, y) for x, y in zip(got["this"], again)):
            bad.append(f"{tag}: two launches differ")
        iters = 10 if s == 9216 else 20
        times = {f"{name}_{p}": [] for name in ("other", "this") for p in ("dkv", "dq")}
        for name in ("other", "this", "this", "other"):
            for p in ("dkv", "dq"):
                times[f"{name}_{p}"].append(cs.cuda_ms(torch, lambda: passes(name, (p,)), iters))
        row["ms"] = times
        if dtype == torch.bfloat16:
            row["sdpa_bwd_ms"], row["sdpa_fwd_bwd_ms"] = cs.sdpa_times(torch, F, q, k, v, do,
                                                                       scale, iters)
            row["sdpa_bwd_graph_ms"] = cs.sdpa_bwd_graph_ms(torch, F, q, k, v, do, scale, iters)
            row["this_graph_ms"] = cs.graph_ms(torch, lambda: passes("this"), iters)
        rows.append(row)
        pair = {name: [a + b_ for a, b_ in zip(times[f"{name}_dkv"], times[f"{name}_dq"])]
                for name in ("other", "this")}
        extra = ""
        if "sdpa_bwd_ms" in row:
            extra = (f"; sdpa bwd {row['sdpa_bwd_ms']:.4f} ms (graph "
                     f"{row['sdpa_bwd_graph_ms']:.4f}), this as a graph "
                     f"{row['this_graph_ms']:.4f}")
        print(f"{tag}: {verdict}; dkv + dq ms, other "
              f"{['%.4f' % t for t in pair['other']]}, this "
              f"{['%.4f' % t for t in pair['this']]} (dkv this "
              f"{['%.4f' % t for t in times['this_dkv']]}, dq this "
              f"{['%.4f' % t for t in times['this_dq']]}){extra}", flush=True)
    host = host_us(argv[1], other)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k4_compare.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "host_us": host, "failures": bad}, f, indent=1)
    for line in bad:
        print("FAIL", line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
