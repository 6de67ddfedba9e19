"""bf16 sums in the order of the JAX package's compiled program, for the
backward of the norms' broadcasts (``csrc/window_sum.cu``).

The bf16 group norm and layer norm broadcast their rounded mean, inverse
deviation and shift; the backward of a broadcast is a sum of bf16
cotangents. XLA compiles it with a bf16 accumulator, rounding after every
add, and its CPU compiler cuts each reduced dimension longer than
:data:`WINDOW` into windows of that length (zeros padded half below, half
above), sums each window sequentially in row-major order and reduces the
windows again, until no reduced dimension is longer than the window; then
it sums what is left sequentially (:func:`stages`). :func:`window_sum` is
that sum; :func:`broadcast_sum` sums a broadcast's cotangent with it (the
bf16 norms' backward, ``models/nn.py``).

On a CPU tensor :func:`window_sum` runs its plain version; on a CUDA tensor
it launches the kernels of ``csrc/window_sum.cu`` once a stage, from one
call, or raises, and counts the launches in ``window_sum.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

#: The window of XLA's CPU tree-reduction rewrite.
WINDOW = 32

Stage = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]


def stages(sizes: Sequence[int], dims: Sequence[int]) -> List[Stage]:
    """``[(window, low padding, output extents), ...]`` per dimension for
    each stage of the sum of a tensor of extents ``sizes`` over ``dims``:
    windows of :data:`WINDOW` while a reduced extent exceeds it, then one
    window over all that is left. Kept dimensions have window 1."""
    sizes, out = list(sizes), []
    while True:
        final = all(sizes[d] <= WINDOW for d in dims)
        w = [(s if final or s <= WINDOW else WINDOW) if d in dims else 1
             for d, s in enumerate(sizes)]
        n = [-(-s // k) for s, k in zip(sizes, w)]
        lo = [(m * k - s) // 2 for s, k, m in zip(sizes, w, n)]
        out.append((tuple(w), tuple(lo), tuple(n)))
        if final:
            return out
        sizes = n


def window_sum_plain(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` (bf16) summed over ``dims`` stage by stage (:func:`stages`),
    each window from 0 in row-major order with the running sum rounded to
    bf16 after every add (PyTorch's bf16 add: in f32, then rounded); the
    reduced dimensions kept with extent 1."""
    v = x
    for w, lo, n in stages(x.shape, dims):
        pad = []
        for s, k, m, p in reversed(list(zip(v.shape, w, n, lo))):
            pad += [p, m * k - s - p]
        v = F.pad(v, pad).reshape([e for m, k in zip(n, w) for e in (m, k)])
        nd = len(n)
        v = v.permute([2 * d + 1 for d in range(nd)] + [2 * d for d in range(nd)])
        v = v.reshape(-1, *n).contiguous()       # window positions first
        acc = torch.zeros(n, dtype=torch.bfloat16, device=v.device)
        for p in range(v.shape[0]):
            acc = acc + v[p]
        v = acc
    return v


@functools.lru_cache(maxsize=None)
def _plan(shape: Tuple[int, ...], stride: Tuple[int, ...], dims: Tuple[int, ...]):
    """The C entry's plan for a sum (extents, strides, then each stage's
    windows, low padding and output extents), the stages' output sizes and
    the sum's extents. One per geometry: the backward asks for the same
    few again and again."""
    st = stages(shape, dims)
    flat = [*shape, *stride, *(v for w, lo, n in st for v in (*w, *lo, *n))]
    return ((ctypes.c_longlong * len(flat))(*flat),
            [math.prod(n) for _, _, n in st], st[-1][2])


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.library("window_sum")
    fn = lib.p2p_window_sum_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def window_sum(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` (bf16, any strides, at most 5 dimensions in the JAX package's
    order) summed over ``dims`` as :func:`window_sum_plain` sums it; the
    reduced dimensions kept with extent 1. On the card one call launches
    every stage, each counted in ``window_sum.launches``."""
    if x.device.type == "cpu":
        return window_sum_plain(x, dims)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not 1 <= x.dim() <= 5:
        raise ValueError(f"window_sum: a CUDA bf16 tensor of 1 to 5 dimensions, "
                         f"not {x.dtype} {tuple(x.shape)} on {x.device}")
    plan, sizes, out_shape = _plan(tuple(x.shape), tuple(x.stride()), tuple(dims))
    lib, fn = _entry()
    buf = torch.empty(sum(sizes), dtype=torch.bfloat16, device=x.device)
    status = fn(x.data_ptr(), buf.data_ptr(), x.dim(), len(sizes), ctypes.addressof(plan),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, status, "p2p_window_sum_bf16")
    window_sum.launches += len(sizes)
    return buf[-sizes[-1]:].view(out_shape)


window_sum.launches = 0


def broadcast_sum(c: torch.Tensor, shape: Sequence[int],
                  order: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``c`` (bf16) summed to ``shape`` by :func:`window_sum`: over the
    dimensions where ``shape`` is 1 and ``c`` is not, with the dimensions of
    ``c`` taken in the JAX package's order (``order``: the dimensions of
    ``c`` in that order; None: the same) — the cotangent of a broadcast of
    a tensor of ``shape`` to ``c``'s."""
    order = list(range(c.dim())) if order is None else list(order)
    dims = [i for i, d in enumerate(order) if shape[d] == 1 and c.shape[d] != 1]
    back = sorted(range(len(order)), key=order.__getitem__)
    return window_sum(c.permute(order), dims).permute(back)

