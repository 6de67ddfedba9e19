#!/usr/bin/env python3
"""K1 and K3 in bf16 at head dim 64 (and at d = 512, below) from another
checkout against this checkout's ``p2p_flash_attn_fwd_bf16_sm90``
(``csrc/flash_fwd_sm90.cu``),
on the card, on the same inputs: the other checkout's
``p2p_flash_attn_fwd_bf16_sm90`` where it has that source (then held bit
for bit), else its ``csrc/flash_attn.cu``'s ``p2p_flash_attn_fwd_bf16``.

    python tools/k1_compare.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of this repository, e.g. the
parent commit unpacked by ``git archive``; its source is built with this
checkout's ``nvcc`` flags into ``build/p2p_tpu_torch/``. Shapes: K1 at
(4, 5, 9216, 64), (4, 10, 2304, 64) and (4, 5, 4096, 64), K3 (``m`` and
``l`` too) at (1, 5, 9216, 64), (1, 10, 2304, 64) and (1, 5, 4096, 64).
Each pair of outputs is held within ``BF16_TOL`` of the other's largest
magnitude (against the mma.sync kernel not bitwise: the key tile moves
where P rounds), ``m`` and ``l`` within ``TC_TOL`` relative, and each
output against the plain version within the same bars; against another
sm90 kernel also bit for bit. The two are timed in turns (other, this, this, other) beside
SDPA in bf16 and the bound. Then d = 40, which stays on the ``mma.sync``
kernel: both checkouts' ``p2p_flash_attn_fwd_bf16`` at (1, 8, 4096, 40),
``m`` and ``l`` too, bit for bit; then the host's µs a call at a shape
whose device time is short, C entry against C entry, and wrapper against
wrapper (each in a process of its own) when OTHER_CHECKOUT holds the whole
package. Writes ``chiprun_out/k1_compare.json``. Exits 1 if an output is out
of its bar. Needs one CUDA card.

Also d = 512, the VAE's head: bf16 K1 at (1, 1, 4096, 512) and (1, 1,
9216, 512) and K3 at (1, 1, 4100, 512) from this checkout's
``flash_d512_sm90_kernel`` against the other checkout's bf16 d = 512
kernel (its ``flash_d512_sm90_kernel`` where its ``flash_fwd_sm90.cu`` has
one, then bit for bit, else its ``mma.sync`` kernel behind
``p2p_flash_attn_fwd_bf16``, within ``BF16_TOL`` of the largest magnitude:
the key tile moves where P rounds), and f32 K1 at (1, 1, 4096, 512), (1, 1,
9216, 512) and (2, 1, 9216, 512) against the other's ``flash_d512_kernel``
(within ``TC_TOL`` of each other and of the plain version; bit for bit
where the two take the same key split); each side with its own tree's key
split (the other's where its ``kernels/flash.py`` has ``d512_splits`` the
same as this one's, else its rule of splitting only below one round of
blocks), timed in turns (other, this, this, other), merge included, beside
SDPA in the same dtype.
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
from p2p_tpu_torch.kernels import build, flash  # noqa: E402

SHAPES = (((4, 5, 9216, 64), False), ((4, 10, 2304, 64), False),
          ((4, 5, 4096, 64), False), ((1, 5, 9216, 64), True),
          ((1, 10, 2304, 64), True), ((1, 5, 4096, 64), True))
HOST_SHAPE = (1, 2, 300, 64)   # and Sk = 70: the host, not the device, sets the pace
HOST_CALLS = 2000
# A checkout's K1 wrapper, host µs a call at HOST_SHAPE, in a process of its
# own (argv: checkout, calls); prints the figure last.
WRAPPER_TIMING = r"""
import sys, time, torch
sys.path.insert(0, sys.argv[1])
from p2p_tpu_torch import kernels as K
g = torch.Generator("cuda").manual_seed(0)
q = torch.randn((1, 2, 300, 64), generator=g, device="cuda").to(torch.bfloat16)
k, v = (torch.randn((1, 2, 70, 64), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(2))
for _ in range(50):
    K.flash_attention(q, k, v, 0.125)
torch.cuda.synchronize()
n = int(sys.argv[2])
t0 = time.perf_counter()
for _ in range(n):
    K.flash_attention(q, k, v, 0.125)
print((time.perf_counter() - t0) / n * 1e6)
torch.cuda.synchronize()
"""


def wrapper_us(checkout: str) -> float:
    """Host µs a call of ``checkout``'s ``kernels.flash_attention`` in bf16 at
    d = 64 (it builds its own library on first use)."""
    out = subprocess.run([sys.executable, "-c", WRAPPER_TIMING, checkout, str(HOST_CALLS)],
                         cwd=checkout, capture_output=True, text=True, check=True)
    return float(out.stdout.split()[-1])


_OTHER_LIBS: dict = {}


def other_entry(checkout: str, name: str, entry: str):
    """The other checkout's forward ``entry`` of ``csrc/<name>.cu``, built
    here once a source, typed."""
    lib = _OTHER_LIBS.get(name)
    if lib is None:
        out = build.BUILD_DIR / f"lib{name}-other.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(out),
                        os.path.join(checkout, f"p2p_tpu_torch/csrc/{name}.cu")],
                       check=True, capture_output=True)
        lib = _OTHER_LIBS[name] = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


D512_BF16 = (((1, 1, 4096, 512), False), ((1, 1, 9216, 512), False), ((1, 1, 4100, 512), True))
D512_F32 = ((1, 1, 4096, 512), (1, 1, 9216, 512), (2, 1, 9216, 512))


def parent_splits(blocks: int, key_tiles: int, sms: int) -> int:
    """The key splits of a tree before ``d512_splits``: only below one round
    of blocks, by the rule ``key_splits`` keeps there, in 64-key tiles."""
    return 1 if blocks >= sms else flash.key_splits(blocks, key_tiles, sms)


def d512_part(checkout: str, sms: int, gen, stream, bad: list) -> list:
    """The d = 512 comparison against ``checkout`` (module docstring)."""
    csrc = os.path.join(checkout, "p2p_tpu_torch/csrc")
    other_sm90 = "flash_d512_sm90_kernel" in open(os.path.join(csrc, "flash_fwd_sm90.cu")).read() \
        if os.path.exists(os.path.join(csrc, "flash_fwd_sm90.cu")) else False
    flash_py = os.path.join(checkout, "p2p_tpu_torch/kernels/flash.py")
    same_rule = os.path.exists(flash_py) and "def d512_splits" in open(flash_py).read()
    entries = {
        ("other", torch.bfloat16): (other_entry(checkout, "flash_fwd_sm90",
                                                "p2p_flash_attn_fwd_bf16_sm90") if other_sm90
                                    else other_entry(checkout, "flash_attn",
                                                     "p2p_flash_attn_fwd_bf16")),
        ("other", torch.float32): other_entry(checkout, "flash_attn", "p2p_flash_attn_fwd"),
        ("this", torch.bfloat16): flash.forward_entry(flash.entry_for(torch.bfloat16, 512)),
        ("this", torch.float32): flash.forward_entry(flash.entry_for(torch.float32, 512))}

    def splits(side, dtype, b, s):
        if side == "this" or same_rule:
            return flash.d512_splits(dtype, b, s, s, sms)
        other_tile = 128 if (dtype == torch.bfloat16 and other_sm90) else 64
        return parent_splits(b * -(-s // flash.D512_TILE), -(-s // other_tile), sms)

    rows = []
    cases = [(shape, k3, torch.bfloat16) for shape, k3 in D512_BF16] + \
            [(shape, False, torch.float32) for shape in D512_F32]
    for shape, k3, dtype in cases:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        n = {side: splits(side, dtype, b, s) for side in ("other", "this")}
        bufs = {}
        for side in ("other", "this"):
            o = torch.empty_like(q)
            m, l = ([torch.empty((b, h, s), device="cuda") for _ in range(2)] if k3
                    else (None, None))
            part = (torch.empty(n[side] * b * h * s * (d + 2), device="cuda")
                    if n[side] > 1 else None)
            bufs[side] = (o, m, l, part)

        def call(side):
            lib, fn = entries[(side, dtype)]
            o, m, l, part = bufs[side]
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        None if m is None else m.data_ptr(),
                        None if l is None else l.data_ptr(),
                        None if part is None else part.data_ptr(), n[side], b * h, s, s, d,
                        d ** -0.5, stream)
            build.check(lib, status, f"{side} d = 512 forward")

        for side in ("other", "this"):
            call(side)
        torch.cuda.synchronize()
        again = bufs["this"][0].clone()
        call("this")
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        tag = f"{'K3' if k3 else 'K1'} {'bf16' if bf16 else 'f32'} {shape}"
        p_o, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, d ** -0.5)
        checks = [("out", 0, p_o, cs.BF16_TOL if bf16 else cs.TC_TOL)]
        if k3:
            checks += [("m", 1, p_m, cs.TC_TOL), ("l", 2, p_l, cs.TC_TOL)]
        errs = {}
        bitwise = (other_sm90 or not bf16) and n["other"] == n["this"]
        for what, i, want, tol in checks:
            this, other = bufs["this"][i], bufs["other"][i]
            for key, a, ref in (("this_vs_other", this, other), ("this_vs_plain", this, want),
                                ("other_vs_plain", other, want)):
                e = cs.max_err(torch, a, ref)
                if bf16 or what != "out":
                    e /= ref.double().abs().max().item()
                errs[f"{what} {key}"] = e
                if e > tol:
                    bad.append(f"{tag} {what} {key}: {e:.3g} > {tol}")
            if bitwise and not torch.equal(this, other):
                bad.append(f"{tag} {what}: not bit for bit the other tree's")
        if not torch.equal(bufs["this"][0], again):
            bad.append(f"{tag}: two launches differ")
        times = {"other": [], "this": []}
        iters = 5 if not bf16 else 10
        for side in ("other", "this", "this", "other"):
            times[side].append(cs.cuda_ms(torch, lambda: call(side), iters))
        sdpa = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5), iters)
        row = {"shape": list(shape), "dtype": "bf16" if bf16 else "f32", "k3": k3,
               "key_splits": n, "bitwise_expected": bitwise, "errors": errs,
               "other_ms": times["other"], "this_ms": times["this"], "sdpa_ms": sdpa,
               **cs.bound(4.0 * b * h * s * s * d, 4 * q.element_size() * q.numel(), True,
                          bf16=bf16)}
        rows.append(row)
        print(f"{tag}: splits other {n['other']} this {n['this']}; other {times['other']} ms, "
              f"this {times['this']} ms, sdpa {sdpa:.4f} ms, bound {row['bound_ms']:.4f} ms; " +
              ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items()))
    return rows


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device is visible", file=sys.stderr)
        return 2
    # Bit for bit at d = 64 only against another sm90 kernel.
    bitwise64 = os.path.exists(os.path.join(argv[1], "p2p_tpu_torch/csrc/flash_fwd_sm90.cu"))
    entries = {"other": (other_entry(argv[1], "flash_fwd_sm90", "p2p_flash_attn_fwd_bf16_sm90")
                         if bitwise64 else
                         other_entry(argv[1], "flash_attn", "p2p_flash_attn_fwd_bf16")),
               "other_d40": other_entry(argv[1], "flash_attn", "p2p_flash_attn_fwd_bf16"),
               "this": flash.forward_entry("p2p_flash_attn_fwd_bf16_sm90"),
               "this_d40": flash.forward_entry("p2p_flash_attn_fwd_bf16")}
    same64 = True
    card = cs.card_line()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(21)
    stream = torch.cuda.current_stream().cuda_stream
    bad, rows = [], []

    def call(name, q, k, v, o, m, l, sk):
        lib, fn = entries[name]
        b, h, sq, d = q.shape
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None if m is None else m.data_ptr(),
                    None if l is None else l.data_ptr(), None, 1, b * h, sq, sk, d,
                    d ** -0.5, stream)
        build.check(lib, status, f"{name} forward")

    for shape, k3 in SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))

        def outputs():   # (o, m, l), m and l None for K1
            res = [torch.empty((b, h, s), device="cuda") for _ in range(2)] if k3 else [None] * 2
            return (torch.empty_like(q), *res)

        bufs = {name: outputs() for name in ("other", "this")}
        for name, (o, m, l) in bufs.items():
            call(name, q, k, v, o, m, l, s)
        again = outputs()
        call("this", q, k, v, *again, s)
        torch.cuda.synchronize()
        tag = f"{'K3' if k3 else 'K1'} {shape}"
        p_o, p_l, p_m = K.flash_attention_residuals_plain(q, k, v, d ** -0.5)
        errs = {}
        checks = [("out", 0, p_o, cs.BF16_TOL)]
        if k3:
            checks += [("m", 1, p_m, cs.TC_TOL), ("l", 2, p_l, cs.TC_TOL)]
        for what, i, want, tol in checks:
            this, other = bufs["this"][i], bufs["other"][i]
            for key, a, ref in (("this_vs_other", this, other), ("this_vs_plain", this, want),
                                ("other_vs_plain", other, want)):
                e = cs.max_err(torch, a, ref) / ref.double().abs().max().item()
                errs[f"{what} {key}"] = e
                if e > tol:
                    bad.append(f"{tag} {what} {key}: {e:.3g} > {tol}")
            if not torch.equal(this, again[i]):
                bad.append(f"{tag} {what}: two launches differ")
            if bitwise64 and not torch.equal(this, other):
                same64 = False
                bad.append(f"{tag} {what}: not bit for bit the other sm90 kernel's")
        times = {"other": [], "this": []}
        iters = 10 if s == 9216 else 20
        for name in ("other", "this", "this", "other"):
            times[name].append(cs.cuda_ms(torch, lambda: call(name, q, k, v, *bufs[name], s),
                                          iters))
        sdpa = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5), iters)
        blocks = -(-s // 128) * b * h
        row = {"shape": list(shape), "k3": k3, "errors": errs,
               "other_ms": times["other"], "this_ms": times["this"], "sdpa_bf16_ms": sdpa,
               "blocks": blocks, "waves": blocks / sms,
               **cs.bound(4.0 * b * h * s * s * d, 4 * 2 * q.numel() + (8 * b * h * s if k3 else 0),
                          True, bf16=True)}
        rows.append(row)
        print(f"{tag}: other {times['other']} ms, this {times['this']} ms, sdpa bf16 "
              f"{sdpa:.4f} ms, bound {row['bound_ms']:.4f} ms, {blocks} blocks = "
              f"{row['waves']:.2f} waves; " +
              ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items()))

    # d = 40 stays on the mma.sync kernel of attn_bf16.cuh: bit for bit the
    # other checkout's, with and without m and l.
    shape = (1, 8, 4096, 40)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    same40 = True
    for k3 in (False, True):
        d40 = {}
        for name in ("other_d40", "this_d40"):
            res = [torch.empty(shape[:3], device="cuda") for _ in range(2)] if k3 else [None] * 2
            d40[name] = (torch.empty_like(q), *res)
            call(name, q, k, v, *d40[name], shape[2])
        same40 &= all(a is None or torch.equal(a, b)
                      for a, b in zip(d40["other_d40"], d40["this_d40"]))
    print(f"K1 and K3 bf16 d=40 {shape}: out (and m, l) bitwise equal to the other "
          f"checkout's: {same40}")
    if bitwise64:
        print(f"K1 and K3 bf16 d=64, the six shapes: out (and m, l) bitwise equal to the "
              f"other checkout's sm90 kernel: {same64}")
    if not same40:
        bad.append("d = 40: outputs differ from the other checkout's")
    rows512 = d512_part(argv[1], sms, gen, stream, bad)

    # The host's time a call: C entry against C entry, then wrapper against
    # wrapper (each checkout's in a process of its own) where the other
    # checkout has the package.
    b, h, sq, d = HOST_SHAPE
    q = torch.randn(HOST_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, h, 70, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o = torch.empty_like(q)
    host = {}
    for name, fn in (("other_entry", lambda: call("other", q, k, v, o, None, None, 70)),
                     ("this_entry", lambda: call("this", q, k, v, o, None, None, 70)),
                     ("this_wrapper", lambda: K.flash_attention(q, k, v, d ** -0.5)),
                     ("this_entry_2", lambda: call("this", q, k, v, o, None, None, 70)),
                     ("other_entry_2", lambda: call("other", q, k, v, o, None, None, 70))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        host[name] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    if os.path.exists(os.path.join(argv[1], "p2p_tpu_torch", "kernels", "flash.py")):
        for name, checkout in (("other_wrapper", argv[1]), ("this_wrapper_process", ROOT),
                               ("this_wrapper_process_2", ROOT),
                               ("other_wrapper_2", argv[1])):
            host[name] = wrapper_us(checkout)
    print("host µs a call at (1, 2, 300, 64), Sk = 70: " +
          ", ".join(f"{n} {us:.2f}" for n, us in host.items()))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k1_compare.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "d512_rows": rows512, "d40_bitwise": same40,
                   "d64_bitwise": same64 if bitwise64 else None, "host_us": host,
                   "failures": bad}, f, indent=1)
    for line in bad:
        print("FAIL", line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
