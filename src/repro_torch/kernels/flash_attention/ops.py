"""Wrapper for flash attention (K3), forward and gradient.

``flash_attention`` is what ``models.layers.attention`` calls for every
full-sequence attention on the card (``forward``, the dense engine's
prefill, ``loss``), at any sq. On CUDA tensors it launches the hand-written
kernel in ``csrc/flash_attention.cu`` (built with nvcc at first use) or
raises; it never falls back. On CPU tensors it runs the plain version in
``ref``, which autograd differentiates. Each launch adds one to
``flash_attention.launches``.

Where an input requires grad (training), the launch goes through
``FlashAttentionFn``: its forward is the same kernel, which also writes
each row's log-sum-exp, and its backward is ``backward.py``'s
FlashAttention-2 backward in torch ops. The TPU kernel has no backward:
the reference trains through XLA's autodiff of its plain attention.

On ``meta`` tensors (the dry-run) every entry returns empty outputs of the
kernel's shapes and dtypes, never the plain version. On ``cuda`` and
``meta`` alike each call adds its work to ``work.count_work``.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import launch, work
from repro_torch.kernels.flash_attention.backward import \
    flash_attention_backward
from repro_torch.kernels.flash_attention.ref import BLOCK_M, \
    attention_lse_ref, attention_ref, key_tile

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_fns: dict = {}


def load_kernel():
    """Build (if needed) and load the kernel; the handle is kept."""
    if "fn" not in _fns:
        _fns["fn"] = launch.bind(SOURCE, "flash_attention", 5, 7, 2)
    return _fns["fn"]


def launch_grid(b: int, sq: int, hq: int, hkv: int, d: int, dv: int,
                dtype) -> dict:
    """The kernel's grid and tiles for these shapes: bf16 blocks of 64 rows
    (query positions x the g q-heads of one kv head) walking key tiles; f32
    blocks of 8 rows walking tiles of 16 keys."""
    rows = sq * (hq // hkv)
    if dtype == torch.bfloat16:
        m, n, threads = BLOCK_M, key_tile(d, dv), 128
    else:
        m, n, threads = 8, 16, 256
    return {"grid": [-(-rows // m), hkv, b], "block_m": m, "block_n": n,
            "threads": threads}


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    pairing: str = "kv_major"):
    """q: (b, sq, hq, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv), the
    model's layout, any sq and skv. Causal: query i sees keys <= i. Returns
    (b, sq, hq, dv) in q's dtype. CUDA tensors launch the kernel (through
    ``FlashAttentionFn`` where an input requires grad), CPU tensors take
    the plain version, meta tensors give the empty output."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             pairing=pairing)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, pairing)
    return _launch(q, k, v, causal, scale, pairing, want_lse=False)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True, scale=None,
                        pairing: str = "kv_major"):
    """(out, lse): ``flash_attention``'s output and each row's
    log-sum-exp of its scaled scores, (b, hq, sq) float32 — the kernel on
    CUDA tensors, the plain versions on CPU tensors. No gradient."""
    launch.check_pairing(pairing)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        kw = dict(causal=causal, scale=scale, pairing=pairing)
        return attention_ref(q, k, v, **kw), attention_lse_ref(q, k, v, **kw)
    return _launch(q, k, v, causal, scale, pairing, want_lse=True)


def _launch(q, k, v, causal: bool, scale: float, pairing: str, *,
            want_lse: bool):
    """One launch of K3: (out, lse or None); on meta the empty outputs."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash attention for device {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv, dk = k.shape[1:]
    dv = v.shape[-1]
    launch.check_inputs({"q": q, "k": k, "v": v})
    if k.shape[0] != b or dk != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    launch.check_heads(hq, hkv, d, dv, k, v)
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (cp.async staging)")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if b == 0 or sq == 0 or skv == 0:
        return out, lse
    work.add("K3", lambda: work.k3_flops(b, sq, skv, hq, d, dv, causal))
    if q.device.type == "meta":
        return out, lse
    launch.run(load_kernel(), "flash_attention", q.device, q.dtype,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr() if want_lse else None, b, sq, skv, hq, hkv, d,
               dv, float(scale), int(causal), launch.PAIRINGS[pairing])
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K3 with a gradient. forward: the kernel (CUDA tensors only), keeping
    q, k, v, its output and each row's log-sum-exp; backward: ``backward.
    flash_attention_backward`` on them (dq, dk, dv in the inputs' dtypes).
    Arguments as ``flash_attention``, with ``scale`` resolved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, pairing: str):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _launch(q, k, v, causal, scale, pairing, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.pairing = causal, scale, pairing
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale,
            pairing=ctx.pairing)
        return dq, dk, dv, None, None, None
