"""Wrapper for decode attention over a contiguous KV cache (K4).

``decode_attention`` is what ``models.attention.gqa_decode`` calls in every
layer of a decode step, with a scalar length (the lockstep decode) or a
(b,) vector of them (the dense engine's slots). On CUDA tensors it launches
the hand-written kernel in ``csrc/decode_attention.cu`` (built with nvcc at
first use) or raises; it never falls back. On CPU tensors it runs the plain
version in ``ref``. Each launch adds one to ``decode_attention.launches``.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_fns: dict = {}


def load_kernel():
    """Build (if needed) and load the kernel; the handle is kept."""
    if "fn" not in _fns:
        _fns["fn"] = launch.bind(SOURCE, "decode_attention", 5, 6, 1)
    return _fns["fn"]


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
    if not torch.is_tensor(kv_len):
        kv_len = torch.full((b,), int(kv_len), dtype=torch.int32,
                            device=q.device)
    launch.check_inputs({"q": q, "cache_k": cache_k, "cache_v": cache_v},
                        {"kv_len": kv_len})
    if cache_k.shape[0] != b or dk != d \
            or cache_v.shape[:3] != cache_k.shape[:3] \
            or kv_len.shape != (b,):
        raise ValueError(f"cache {tuple(cache_k.shape)}/"
                         f"{tuple(cache_v.shape)} and kv_len "
                         f"{tuple(kv_len.shape)} do not match q "
                         f"{tuple(q.shape)}")
    launch.check_heads(hq, hkv, d, dv, cache_k, cache_v)
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or S == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch.run(load_kernel(), "decode_attention", q.device, q.dtype,
               q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
               kv_len.data_ptr(), out.data_ptr(), b, hq, hkv, d, dv, S,
               float(scale), launch.PAIRINGS[pairing])
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
