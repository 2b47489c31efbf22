"""Wrapper for decode attention over a contiguous KV cache (K4).

``decode_attention`` is what ``models.attention.gqa_decode`` calls in every
layer of a decode step, with a scalar length (the lockstep decode) or a
(b,) vector of them (the dense engine's slots). On CUDA tensors it launches
the hand-written kernel in ``csrc/decode_attention.cu`` (built with nvcc at
first use) or raises; it never falls back. On CPU tensors it runs the plain
version in ``ref``. Each call that launches adds one to
``decode_attention.launches`` (the kernel's two passes count as one call).

The kernel splits the cache's keys over its grid; ``split_plan`` chooses
the split from the shapes and the card's SM count, never from the lengths.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
SPLIT_ALIGN = 8          # keys; a split is a multiple of this (or S)
MAX_SPLIT = 128          # keys; one per thread of a block at g = 1
SMEM_BYTES = 227 * 1024  # what one block may hold on an H100
_fns: dict = {}
_sm_counts: dict = {}


def load_kernel():
    """Build (if needed) and load the kernel; the handle is kept."""
    if "fn" not in _fns:
        _fns["fn"] = launch.bind(SOURCE, "decode_attention", 7, 8, 1)
    return _fns["fn"]


def split_plan(S: int, b: int, hkv: int, n_sm: int,
               max_split: int = MAX_SPLIT, align: int = SPLIT_ALIGN):
    """(split, n_split): keys per block of the kernel's first pass and the
    number of ranges covering S. Enough ranges for b * hkv * n_split blocks
    to fill every SM once (``n_sm``), each a multiple of ``align`` keys, at
    most ``max_split``; where S is too short for that, splits of ``align``
    keys. Depends on the shapes only, never on the lengths. The paged
    kernels (K1, K2) plan with ``align`` a page or a key tile."""
    want = -(-n_sm // max(b * hkv, 1))       # ranges per (row, kv head)
    split = S // want // align * align
    split = min(max(split, align), max_split, S)
    return split, -(-S // split)


def smem_bytes(split: int, g: int, d: int, dv: int, es: int) -> int:
    """Shared memory of one first-pass block, as the kernel's ``Layout``
    lays it out: ``split`` K rows of an odd number of 16-byte chunks and V
    rows, q of the g heads as f32, a score per (head, key), each head's
    (m, l), and 4 KB of partial sums."""
    r16 = lambda n: (n + 15) // 16 * 16
    k_bytes = split * ((d * es // 16) | 1) * 16
    return (k_bytes + split * dv * es + g * d * 4 + r16(g * split * 4)
            + r16(g * 8) + 128 * 8 * 4)


def _max_split(g: int, d: int, dv: int, es: int, align: int = SPLIT_ALIGN,
               id_bytes: int = 0) -> int:
    """The most keys (a multiple of ``align``, at most MAX_SPLIT) whose
    first-pass block fits an H100's shared memory: ``smem_bytes``, then
    ``id_bytes`` per ``align`` keys rounded up to 16 bytes (the paged
    decode's page ids, 4 bytes a page, with ``align`` the page size)."""
    def used(split):
        return smem_bytes(split, g, d, dv, es) \
            + (split // align * id_bytes + 15) // 16 * 16

    split = MAX_SPLIT // align * align
    while split > align and used(split) > SMEM_BYTES:
        split -= align
    return split


def sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def kernel_plan(q, cache_k, cache_v):
    """(split, n_split) the kernel runs with for these CUDA tensors."""
    b, _, hq, d = q.shape
    S, hkv = cache_k.shape[1:3]
    limit = _max_split(hq // hkv, d, cache_v.shape[-1], q.element_size())
    return split_plan(S, b, hkv, sm_count(q.device), limit)


def decode_attention(q, cache_k, cache_v, kv_len, *, scale=None,
                     pairing: str = "kv_major"):
    """q: (b, 1, hq, d); cache_k/cache_v: (b, S, hkv, d|dv) in the model's
    layout, read in place; kv_len: an int (every row) or a (b,) int32
    tensor, row b seeing keys ``< kv_len[b]``. Returns (b, 1, hq, dv) in
    q's dtype. CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return decode_attention_ref(q[:, 0], cache_k, cache_v, kv_len,
                                    scale=scale, pairing=pairing)[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (b, 1, hq, d), got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    S, hkv, dk = cache_k.shape[1:]
    dv = cache_v.shape[-1]
    per_row = torch.is_tensor(kv_len)
    launch.check_inputs({"q": q, "cache_k": cache_k, "cache_v": cache_v},
                        {"kv_len": kv_len} if per_row else {})
    if cache_k.shape[0] != b or dk != d \
            or cache_v.shape[:3] != cache_k.shape[:3] \
            or (per_row and kv_len.shape != (b,)):
        raise ValueError(f"cache {tuple(cache_k.shape)}/"
                         f"{tuple(cache_v.shape)} and kv_len "
                         f"{tuple(kv_len.shape) if per_row else kv_len} do "
                         f"not match q {tuple(q.shape)}")
    launch.check_heads(hq, hkv, d, dv, cache_k, cache_v)
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or S == 0:
        return out
    split, n_split = kernel_plan(q, cache_k, cache_v)
    ws_o = torch.empty((b, hq, n_split, dv), dtype=torch.float32,
                       device=q.device)
    ws_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                        device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch.run(load_kernel(), "decode_attention", q.device, q.dtype,
               q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
               kv_len.data_ptr() if per_row else None, out.data_ptr(),
               ws_o.data_ptr(), ws_ml.data_ptr(), b, hq, hkv, d, dv, S,
               split, 0 if per_row else int(kv_len), float(scale),
               launch.PAIRINGS[pairing])
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
