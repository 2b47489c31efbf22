"""Wrapper for the Mamba-2 SSD chunked scan (K5).

``ssd`` is what ``models.ssd.ssd_chunked`` calls in every Mamba-2 layer of
``forward`` and ``prefill`` (the SSM family and the hybrid's backbone). On
CUDA tensors it launches the hand-written kernel in ``csrc/ssd.cu`` (built
with nvcc at first use) or raises; it never falls back. On CPU tensors it
runs the plain version ``ref.ssd_chunked_ref``. Each launch adds one to
``ssd.launches``.

The kernel reads x, B and C in place in the model's layout, strided along
batch and sequence (they are slices of one conv output), so the wrapper
makes no copy of them; it takes a compute-dtype x/B/C beside float32
dt/A/state, so it has its own input check rather than
``launch.check_inputs``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.ssd.ref import chunk_len, ssd_chunked_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
HEAD_DIMS = (16, 32, 64, 128)
MAX_SMEM_BYTES = 232448          # what one block may use on Hopper
_fns: dict = {}


def load_kernel():
    """Build (if needed) and load the kernel; the handles are kept."""
    if "fn" not in _fns:
        lib = build.load(SOURCE)
        fn = lib.ssd_chunked
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_longlong
        _fns["fn"], _fns["smem"] = fn, smem
    return _fns["fn"]


def _check(x, dt, A, B, C, initial_state):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in launch.DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (the kernel takes "
                        f"{sorted(map(str, launch.DTYPE_CODES))})")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}; x, B and C must share "
                            "one dtype")
    floats = {"dt": dt, "A": A}
    if initial_state is not None:
        floats["initial_state"] = initial_state
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {"dt": dt, "A": A, "B": B, "C": C, **floats}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, not {x.device}")
    if dt.shape != (b, s, h) or A.shape != (h,) \
            or B.shape != (b, s, g, n) or C.shape != B.shape or h % g:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not fit (b, s, h, p), "
                         "(b, s, h), (h,), (b, s, g, n) with h % g == 0")
    if initial_state is not None and \
            initial_state.shape != (b, g, h // g, n, p):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                         f"not {(b, g, h // g, n, p)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not in {HEAD_DIMS}")
    for name, t, inner in (("x", x, p), ("B", B, n), ("C", C, n)):
        if t.stride(3) != 1 or t.stride(2) != inner:
            raise ValueError(f"{name}'s last two dims must be contiguous")
    for name, t in {"dt": dt, "A": A, **floats}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd(x, dt, A, B, C, chunk: int,
        initial_state: Optional[torch.Tensor] = None):
    """x (b, s, h, p) and B, C (b, s, g, n) in the compute dtype; dt
    (b, s, h) and A (h,) float32; initial_state (b, g, h/g, n, p) float32
    or None (zeros). Returns (y (b, s, h, p) in x's dtype, final state
    (b, g, h/g, n, p) float32). Raises ``ValueError`` unless
    ``min(chunk, s)`` divides s. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan for device {x.device}")
    if x.ndim != 4 or B.ndim != 4 or C.ndim != 4:
        raise ValueError("x, B and C must be 4-d")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = chunk_len(s, chunk)
    _check(x, dt, A, B, C, initial_state)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, g, h // g, n, p), dtype=torch.float32,
                        device=x.device)
    if b == 0:
        return y, state
    fn = load_kernel()
    smem = _fns["smem"](n, p, L)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d_state {n}, head dim {p}, chunk {L} need {smem} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}")
    launch.run(fn, "ssd", x.device, x.dtype, x.data_ptr(), dt.data_ptr(),
               A.data_ptr(), B.data_ptr(), C.data_ptr(),
               initial_state.data_ptr() if initial_state is not None
               else None, y.data_ptr(), state.data_ptr(), b, s, h, p, g, n,
               L, x.stride(0), x.stride(1), B.stride(0), B.stride(1),
               C.stride(0), C.stride(1))
    ssd.launches += 1
    return y, state


ssd.launches = 0
