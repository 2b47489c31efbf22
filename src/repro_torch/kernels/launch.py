"""What the port's attention wrappers share: the checks a tensor must pass
before its kernel takes it, the lazily bound C entry points, and the launch
on the caller's stream. Nothing here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# added to q's code where the attention kernels' K/V are float8_e4m3fn
# (read from e4m3 pages, each element widened exactly in registers)
KV_FP8_CODE = 2
PAIRINGS = {"kv_major": 0, "g_major": 1}
MAX_HEAD_DIM = 256


def check_pairing(pairing: str) -> None:
    if pairing not in PAIRINGS:
        raise ValueError(f"pairing {pairing!r} not in {sorted(PAIRINGS)}")


def check_inputs(floats: dict, ints: dict = None, kv=()) -> None:
    """Every tensor on the first float tensor's device and contiguous; the
    float tensors of one supported dtype, the integer tensors int32. The
    float tensors named in ``kv`` (an attention kernel's K and V) may
    instead be float8_e4m3fn together: q float32 or bfloat16 with K/V of
    q's dtype or of float8_e4m3fn are the pairs the kernels take."""
    ints = ints or {}
    first = next(iter(floats.values()))
    for name, t in {**floats, **ints}.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {first.dtype} not supported (kernels take "
                        f"{sorted(map(str, DTYPE_CODES))})")
    fp8 = torch.float8_e4m3fn
    kv_dtype = fp8 if kv and floats[kv[0]].dtype == fp8 else first.dtype
    for name, t in floats.items():
        want = kv_dtype if name in kv else first.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, not {want}: the float "
                            f"tensors share {first.dtype}, or "
                            f"{'/'.join(kv) or 'none'} may be {fp8} "
                            "together")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


def dtype_code(dtype: torch.dtype, kv_dtype: torch.dtype = None) -> int:
    """The C entry points' dtype argument: q's code, plus ``KV_FP8_CODE``
    where K/V are float8_e4m3fn."""
    return DTYPE_CODES[dtype] + (KV_FP8_CODE if kv_dtype
                                 == torch.float8_e4m3fn else 0)


def check_heads(hq: int, hkv: int, d: int, dv: int, k, v) -> None:
    """GQA grouping, head dims the kernels hold in registers, and K/V rows
    that are whole, aligned 16-byte chunks of K/V's own elements (the
    cp.async staging: 16 fp8 elements a chunk, so d = 16 is one)."""
    if hkv < 1 or hq % hkv:
        raise ValueError(f"hq {hq} is not a multiple of hkv {hkv}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    es = k.element_size()
    if (d * es) % 16 or (dv * es) % 16 \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V rows must be whole, aligned 16-byte chunks "
                         f"(d={d}, dv={dv}, {es}-byte elements)")


def bind(source: Path, name: str, n_ptrs: int, n_ints: int,
         n_tail_ints: int = 0):
    """The C function ``name`` of ``source`` (built and loaded on first
    use): int dtype, ``n_ptrs`` pointers, ``n_ints`` ints, float scale,
    ``n_tail_ints`` ints, stream. Pointers and the stream pass as 64-bit
    values."""
    fn = getattr(build.load(source), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_int] * n_ints + [ctypes.c_float]
                   + [ctypes.c_int] * n_tail_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run(fn, name: str, dev: torch.device, dtype: torch.dtype, *args,
        kv_dtype: torch.dtype = None) -> None:
    """Launch on ``dev``'s current stream of the calling thread, with the
    dtype code of q's ``dtype`` and the K/V's ``kv_dtype`` (``dtype_code``);
    raises if the launch was refused."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(dtype_code(dtype, kv_dtype), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
