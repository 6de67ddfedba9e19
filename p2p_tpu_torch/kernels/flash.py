"""K1 and K3: flash attention forward — wrappers, plain versions and launch
counts.

K1 (:func:`flash_attention`) replaces the JAX package's
``flash_attention_tpu`` (``p2p_tpu/models/nn.py``, the Pallas TPU library
kernel behind ``fused_attention``); K3 (:func:`flash_attention_residuals`)
replaces ``flash_attention_residuals``, the same Pallas kernel with
``save_residuals=True`` — also its forward rule under differentiation. Both
launch CUDA kernels: non-causal, unmasked ``softmax(q·kᵀ·scale)·v`` in f32,
blockwise with an online softmax, so the (S, S) scores never exist in
device memory; K3 also writes each row's max ``m`` and sum ``l`` of
``exp(s − m)``. At the paths' head dims, 40, 64 (the SD-2.1 U-Net) and 512,
the kernels run on the tensor cores in 3xTF32 (f32 accuracy; :mod:`.tf32`
emulates them, :func:`.tf32.flash_d40` the d = 40 and d = 64 kernels step
by step): at d = 40 and 512 in ``csrc/flash_attn.cu`` (``mma.sync``), at
d = 64 on Hopper's tf32 ``wgmma`` and TMA in ``csrc/flash_fwd_tf32_sm90.cu``
(a library of its own, ``flash_fwd_tf32_sm90_kernel``, 64 keys a tile,
after ``flash_split_kv_tf32_kernel`` has split K and V once into scratch the
wrapper allocates: :func:`f32_d64_scratch`);
d = 80 and 160, which no path runs, use an f32 kernel on the CUDA cores of
``csrc/flash_attn.cu``. A d = 512 kernel fills an SM with one block
of 64 query rows, so it may split the keys among several blocks
(:func:`key_splits`: when the query tiles leave SMs idle, too few for one
round or a short last round); a second kernel (``csrc/flash_merge.cuh``)
merges the partial outputs in a fixed order (:func:`merge_partials` is its
plain version). Main-path shapes: K1 at the U-Net's 64²-pixel self sites,
q/k/v ``(4, 8, 4096, 40)``, and the VAE's mid attention ``(2, 1, 4096,
512)`` (no split) and ``(1, 1, 4096, 512)`` (two splits, in the
inversion's encode and decode); K3 at ``(1, 8, 4096, 40)`` in the
null-text inversion's gradient steps. SD-2.1 runs K1 at ``(4, 5, 9216,
64)`` and ``(4, 10, 2304, 64)`` (768-v) or ``(4, 5, 4096, 64)`` (512-base),
and its VAE at ``(2, 1, 9216, 512)`` and, in the inversion, ``(1, 1, 9216,
512)``, whose 288 and 144 blocks leave a short last round on 132 SMs.

K1 and K3 also take bf16 q, k and v, on Hopper's ``wgmma`` and TMA in
``csrc/flash_fwd_sm90.cu`` (a library of its own), 128 keys a tile: at
d = 40 (the U-Net's 64²-pixel self sites of a bf16 edit, and of a bf16
inversion's forwards and gradients) and d = 64 (SD-2.1's self sites)
``flash_fwd_sm90_kernel<DH>``, whose 40-column rows land by TMA in the
64-column swizzled layout of d = 64; at d = 512 (the bf16 VAE encode of a
bf16 inversion, (1, 1, 4096, 512) and (1, 1, 9216, 512))
``flash_d512_sm90_kernel``, with the key split and merge. Each is one bf16
tensor-core pass a product with f32 accumulation, the unnormalized P of a
key tile rounded to bf16 before P·V as the JAX library kernel rounds it
(``p.astype(v.dtype)``; :data:`.bf16.K1_STEP` is the tile), the output
rounded to bf16 once, ``m`` and ``l`` f32 (``l`` the sum of the unrounded
P).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches by dtype
and head dim (one kernel each) in ``.by_head_dim``, the merges of its
split calls in ``.merge_launches``, and the split passes of its f32 d = 64
calls (one a call) in ``.split_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: Head dims the CUDA kernel is instantiated for, in f32 and in bf16.
SUPPORTED_HEAD_DIMS = (40, 64, 80, 160, 512)
SUPPORTED_HEAD_DIMS_BF16 = (40, 64, 512)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, chunk: int = 1024) -> torch.Tensor:
    """Materialized softmax attention in f32, chunked over queries so the
    (S, S) scores exist only one chunk of rows at a time. The probabilities
    are rounded to ``v``'s dtype before P·V (as the JAX package rounds
    them; the identity in f32) and the output once at the end."""
    outs = []
    for s0 in range(0, q.shape[-2], chunk):
        qc = q[..., s0:s0 + chunk, :].float()
        probs = torch.softmax(
            torch.einsum("bhqd,bhkd->bhqk", qc, k.float()) * scale, dim=-1)
        probs = probs.to(v.dtype).float()
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, v.float()))
    return torch.cat(outs, dim=-2).to(v.dtype)


def flash_attention_residuals_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, scale: float,
                                    chunk: int = 1024):
    """``(out, l, m)`` materialized, chunked over queries: ``m`` the row
    max of ``s = q·kᵀ·scale``, ``l`` the row sum of ``exp(s − m)``, both
    f32 ``(B, H, Sq)`` — the JAX library's residual convention. P is
    rounded to ``v``'s dtype before P·V, as the library rounds it (the
    identity in f32); ``l`` sums it unrounded."""
    outs, ls, ms = [], [], []
    for s0 in range(0, q.shape[-2], chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[..., s0:s0 + chunk, :].float(),
                         k.float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
                    / l[..., None])
        ls.append(l)
        ms.append(m)
    return (torch.cat(outs, dim=-2).to(v.dtype), torch.cat(ls, dim=-1),
            torch.cat(ms, dim=-1))


#: Rows of a query tile of either d = 512 kernel: one block an SM.
D512_TILE = 64
#: Keys a tile of the d = 512 kernel of each dtype: ``flash_d512_kernel``
#: (f32, ``csrc/flash_attn.cu``) and ``flash_d512_sm90_kernel`` (bf16,
#: ``csrc/flash_fwd_sm90.cu``).
D512_KEY_TILE = {torch.float32: 64, torch.bfloat16: 128}
#: The merge's cost in :func:`key_splits`, per dtype: the time one split of
#: a round of blocks adds (its f32 partials, ``D512_TILE·(d + 2)`` values a
#: block, written and read back: 10.4 µs at 3.35 TB/s for 132 blocks) over
#: the time that kernel takes for one key tile (28 µs in f32, 5.0 µs in
#: bf16, unsplit at (1, 1, 9216, 512) on an H100 80GB HBM3 at 700 W;
#: PERF.md §6). With these the rule picks the fastest split of those timed
#: there, or one within the run-to-run spread of it.
D512_MERGE = {torch.float32: 0.37, torch.bfloat16: 2.0}
#: Most key splits the d = 512 kernel is given.
MAX_KEY_SPLITS = 16


def key_splits(blocks: int, key_tiles: int, sms: int,
               merge: float = D512_MERGE[torch.float32]) -> int:
    """Key splits for a d = 512 kernel, which fills an SM with one block,
    at most one split per key tile and ``MAX_KEY_SPLITS``. Fewer
    ``blocks`` (query tiles × batch·heads) than SMs: the fewest that
    minimize the rounds per unit of work, ``⌈blocks·n / sms⌉ / n`` (at (1,
    1, 4096, 512) 2: 128 blocks; 4 splits, two rounds of 256 blocks, measured
    1.7 % slower on an H100). Enough blocks for a round: the fewest that
    minimize the rounds times the longest split's key tiles, ``⌈blocks·n /
    sms⌉·⌈key_tiles / n⌉``, plus ``merge·n·blocks / sms`` for the partials
    of more than one split (``merge``: :data:`D512_MERGE`), so that a
    short last round is filled only where that pays."""
    hi = max(1, min(key_tiles, MAX_KEY_SPLITS))
    if blocks < sms:
        return min(range(1, hi + 1), key=lambda n: (math.ceil(blocks * n / sms) / n, n))

    def cost(n):
        rounds = math.ceil(blocks * n / sms) * math.ceil(key_tiles / n)
        return rounds + (merge * n * blocks / sms if n > 1 else 0.0), n

    return min(range(1, hi + 1), key=cost)


def d512_splits(dtype: torch.dtype, bh: int, sq: int, sk: int, sms: int) -> int:
    """The key splits of a d = 512 call in ``dtype`` over ``bh`` batch·heads
    on a card of ``sms`` SMs (:func:`key_splits` with that dtype's kernel's
    key tile and merge cost)."""
    return key_splits(-(-sq // D512_TILE) * bh, -(-sk // D512_KEY_TILE[dtype]), sms,
                      D512_MERGE[dtype])


def merge_partials(outs, ls, ms):
    """Plain version of the d = 512 kernel's merge: the attention output and
    residuals ``(out, l, m)`` over all keys from each key range's
    unnormalized output ``Σ_j exp(s_j − m_i)·v_j`` with its row max ``m_i``
    and row sum ``l_i``, combined in the order given."""
    m = ms[0]
    for mi in ms[1:]:
        m = torch.maximum(m, mi)
    out = torch.zeros_like(outs[0])
    l = torch.zeros_like(ls[0])
    for oi, li, mi in zip(outs, ls, ms):
        w = torch.exp(mi - m)
        l = l + w * li
        out = out + w[..., None] * oi
    return out / l[..., None], l, m


#: The library of each forward entry: bf16, and f32 at d = 64, run on
#: Hopper's wgmma and TMA in libraries of their own.
ENTRIES = {"p2p_flash_attn_fwd": "flash_attn",
           "p2p_flash_attn_fwd_bf16_sm90": "flash_fwd_sm90",
           "p2p_flash_attn_fwd_f32_sm90": "flash_fwd_tf32_sm90"}
_FORWARD: dict = {}


def forward_entry(entry: str):
    """``(library, function)`` of a forward C entry, its argument types set
    once: q, k, v, o, m, l, part; nsplit, bh, sq, sk, d; scale, stream."""
    found = _FORWARD.get(entry)
    if found is None:
        lib = build.library(ENTRIES[entry])
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        found = _FORWARD[entry] = (lib, fn)
    return found


def f32_d64_scratch(lib: ctypes.CDLL, bh: int, sk: int, device) -> torch.Tensor:
    """f32 scratch on ``device`` for the f32 d = 64 entry over ``bh`` heads
    of ``sk`` keys (``lib``: its library): the split K and V^T its split
    pass writes, as many values as the library asks."""
    size = lib.p2p_flash_attn_fwd_f32_sm90_scratch
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    size.restype = ctypes.c_longlong
    return torch.empty(size(bh, sk), dtype=torch.float32, device=device)


def entry_for(dtype: torch.dtype, d: int) -> str:
    """The forward C entry that runs ``dtype`` at head dim ``d``."""
    if dtype == torch.bfloat16:
        return "p2p_flash_attn_fwd_bf16_sm90"
    return "p2p_flash_attn_fwd_f32_sm90" if d == 64 else "p2p_flash_attn_fwd"


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attn")
    occ = lib.p2p_flash_attn_d40_occupancy
    occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    return lib


def d40_occupancy() -> tuple:
    """``(blocks, warps)``: blocks of the d = 40 kernel resident on one SM of
    the current card, and its warps a block."""
    lib = _lib()
    warps = ctypes.c_int(0)
    blocks = lib.p2p_flash_attn_d40_occupancy(ctypes.byref(warps))
    if blocks < 0:
        build.check(lib, -blocks, "p2p_flash_attn_d40_occupancy")
    return blocks, warps.value


def check_operands(what: str, tensors, head_dims, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned CUDA
    tensor of ``dtype`` (f32 or bf16) on the first one's device and, unless
    ``head_dims`` is None, the head dim (last axis of the first) is one the
    kernel is instantiated for."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: no kernel for {dtype}")
    dev = tensors[0][1].device
    for name, t in tensors:
        if (t.dtype != dtype or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte "
                             f"aligned {dtype} on {dev}, got {t.dtype} on {t.device}")
    d = tensors[0][1].shape[-1]
    if head_dims is not None and d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")


def _launch(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, residuals: bool):
    """One launch of the forward entry for q's dtype and head dim
    (:func:`entry_for`): ``(out, l, m, merged, split)``, with
    ``l`` and ``m`` None unless ``residuals``, ``merged`` whether the
    call split the keys and so also launched the merge kernel, and
    ``split`` whether it launched the f32 d = 64 split pass first."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    bf16 = q.dtype == torch.bfloat16
    check_operands(what, (("q", q), ("k", k), ("v", v)),
                   SUPPORTED_HEAD_DIMS_BF16 if bf16 else SUPPORTED_HEAD_DIMS,
                   torch.bfloat16 if bf16 else torch.float32)
    entry = entry_for(q.dtype, d)
    lib, fn = forward_entry(entry)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    l = m = None
    if residuals:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    nsplit, part = 1, None
    split = entry == "p2p_flash_attn_fwd_f32_sm90"
    if split:
        part = f32_d64_scratch(lib, b * h, sk, q.device)
    if d == 512:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = d512_splits(q.dtype, b * h, sq, sk, sms)
        if nsplit > 1:
            part = torch.empty(nsplit * b * h * sq * (d + 2), dtype=torch.float32,
                               device=q.device)
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        None if part is None else part.data_ptr(), nsplit,
        b * h, sq, sk, d, float(scale), stream)
    build.check(lib, status, entry)
    return out, l, m, nsplit > 1, split


def _count_head_dim(wrapper, q: torch.Tensor) -> None:
    """One more launch of ``wrapper``'s kernel at ``q``'s dtype and head
    dim, in ``wrapper.by_head_dim`` (keys like ``"bf16 d=64"``): each head
    dim has a kernel of its own."""
    key = f"{'bf16' if q.dtype == torch.bfloat16 else 'f32'} d={q.shape[-1]}"
    wrapper.by_head_dim[key] = wrapper.by_head_dim.get(key, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K1: ``softmax(q·kᵀ·scale)·v`` for q ``(B, H, Sq, D)``, k/v
    ``(B, H, Sk, D)``, contiguous, f32 or (at d = 40, 64 and 512) bf16."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    out, _, _, merged, split = _launch("flash_attention", q, k, v, scale,
                                       residuals=False)
    flash_attention.merge_launches += merged
    flash_attention.split_launches += split
    _count_head_dim(flash_attention, q)
    return out


def flash_attention_residuals(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float):
    """K3: ``(out, l, m)`` — K1's output plus each row's softmax sum ``l``
    and max ``m``, f32 ``(B, H, Sq)``; the forward the backward
    (:mod:`.flash_bwd`) pairs with; q, k, v and the output f32 or (at d =
    40, 64 and 512) bf16."""
    if q.device.type == "cpu":
        return flash_attention_residuals_plain(q, k, v, scale)
    out, l, m, merged, split = _launch("flash_attention_residuals", q, k, v, scale,
                                       residuals=True)
    flash_attention_residuals.merge_launches += merged
    flash_attention_residuals.split_launches += split
    _count_head_dim(flash_attention_residuals, q)
    return out, l, m


flash_attention.merge_launches = 0
flash_attention_residuals.merge_launches = 0
flash_attention.split_launches = 0
flash_attention_residuals.split_launches = 0
flash_attention.by_head_dim = {}
flash_attention_residuals.by_head_dim = {}
