"""Wrapper for flash attention, forward (K3).

``flash_attention`` is what ``models.layers.attention`` calls for every
full-sequence attention on the card (``forward``, the dense engine's
prefill), at any sq. On CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (built with nvcc at first use) or raises; it
never falls back. On CPU tensors it runs the plain version in ``ref``. Each
launch adds one to ``flash_attention.launches``.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_fns: dict = {}


def load_kernel():
    """Build (if needed) and load the kernel; the handle is kept."""
    if "fn" not in _fns:
        _fns["fn"] = launch.bind(SOURCE, "flash_attention", 4, 7, 2)
    return _fns["fn"]


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    pairing: str = "kv_major"):
    """q: (b, sq, hq, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv), the
    model's layout, any sq and skv. Causal: query i sees keys <= i. Returns
    (b, sq, hq, dv) in q's dtype. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             pairing=pairing)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv, dk = k.shape[1:]
    dv = v.shape[-1]
    launch.check_inputs({"q": q, "k": k, "v": v})
    if k.shape[0] != b or dk != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    launch.check_heads(hq, hkv, d, dv, k, v)
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or skv == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch.run(load_kernel(), "flash_attention", q.device, q.dtype,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
               sq, skv, hq, hkv, d, dv, float(scale), int(causal),
               launch.PAIRINGS[pairing])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
