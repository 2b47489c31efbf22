"""Wrapper for the Mamba-2 SSD chunked scan (K5).

``ssd`` is what ``models.ssd.ssd_chunked`` calls in every Mamba-2 layer of
``forward`` and ``prefill`` (the SSM family and the hybrid's backbone). On
CUDA tensors it launches the hand-written kernels in ``csrc/ssd.cu`` (built
with nvcc at first use) or raises; it never falls back. On CPU tensors it
runs the plain version ``ref.ssd_chunked_ref``. Each call of the C entry
adds one to ``ssd.launches`` (bf16: two kernels, float32: one).

bf16 runs on the tensor cores in two kernels (the state walk beside C.B^T
once per group, then the output), whose walk is
``ref.ssd_chunked_tiled_ref``; the wrapper allocates their scratch (cum,
C.B^T, the pieces of each chunk's incoming state) with ``torch.empty``.
``kernel_plan`` gives the grids, the state columns and heads each block
serves and the operand splits of a call. float32 runs one block per (row,
head) on the CUDA cores.

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
from repro_torch.kernels.ssd.ref import TILE, chunk_len, ssd_chunked_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE_DIM = 128              # d_state the bf16 kernels hold (n % 16 == 0)
MAX_SMEM_BYTES = 232448          # what one block may use on Hopper
SM_SMEM_BYTES = 233472           # an SM's shared memory, 1 KB of it per block
CHUNK_THREADS, OUT_THREADS = 256, 128
PAD = 8                          # bf16 elements padding a shared row
S_ROWS = 32                      # rows of n per staged piece of h_prev
STATE_COLS = 32                  # state columns a chunk-kernel block carries
STATE_STAGES = 3                 # ring depth of a state walk's tiles
_fns: dict = {}


def state_slice(p: int) -> int:
    """Columns of a head's state one chunk-kernel block carries."""
    return min(p, STATE_COLS)


def smem_bytes(kernel: str, n: int, p: int, L: int) -> int:
    """Dynamic shared memory of one block of ``kernel`` ("f32", "chunk",
    "out"): what ``ssd_smem_bytes`` in csrc/ssd.cu returns."""
    Lt = -(-L // TILE) * TILE
    if kernel == "f32":
        return 4 * (n * p + 2 * TILE * (n + 1) + TILE * p
                    + TILE * (TILE + 1) + 3 * L)
    if kernel == "chunk":    # dt, cum, w, scan totals; a ring of B, x tiles
        return max(4 * Lt * 4 + STATE_STAGES
                   * TILE * (n + PAD + state_slice(p) + PAD) * 2,
                   2 * TILE * (n + PAD) * 2)
    if kernel == "out":      # C tile; x tiles, later two h_prev stages
        region = max(Lt, 6 * S_ROWS)
        return (TILE * (n + PAD) + region * (p + PAD)) * 2 + 2 * Lt * 4
    raise ValueError(f"no kernel {kernel!r}")


def kernel_plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                dtype: torch.dtype) -> dict:
    """How a call at these sizes runs: its route, each kernel's grid
    (blocks), threads, shared memory and the blocks an SM can hold by
    shared memory; the columns of a state each state block carries, the
    heads each output block serves and the heads one C.B^T tile serves;
    the pieces each split product is cut into."""
    L = chunk_len(s, chunk)
    nc, nt = s // L, -(-L // TILE)

    def kern(blocks, threads, smem):
        return {"blocks": blocks, "threads": threads, "smem": smem,
                "resident_by_smem": SM_SMEM_BYTES // (smem + 1024)}

    if dtype == torch.float32:
        return {"route": "f32_walk", "L": L, "nc": nc,
                "kernels": {"f32": kern(b * h, 256,
                                        smem_bytes("f32", n, p, L))}}
    n_state = b * h * (p // state_slice(p))
    n_cb = b * nc * g * nt * (nt + 1) // 2
    return {"route": "tensor_cores", "L": L, "nc": nc, "tiles": nt,
            "kernels": {
                "chunk": kern(n_state + n_cb, CHUNK_THREADS,
                              smem_bytes("chunk", n, p, L)),
                "out": kern(nt * b * nc * h, OUT_THREADS,
                            smem_bytes("out", n, p, L))},
            "state_blocks": n_state, "state_cols": state_slice(p),
            "cb_blocks": n_cb, "heads_per_out_block": 1,
            "heads_per_cb_tile": h // g, "splits": {"w_x": 2, "h_prev": 3}}


def load_kernel():
    """Build (if needed) and load the kernel; the handles are kept."""
    if "fn" not in _fns:
        lib = build.load(SOURCE)
        fn = lib.ssd_chunked
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.ssd_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_longlong
        _fns["fn"], _fns["smem"] = fn, smem
    return _fns["fn"]


def built_smem_bytes(kernel: str, n: int, p: int, L: int) -> int:
    """What the built kernels ask for (``ssd_smem_bytes``), which
    ``smem_bytes`` mirrors; needs the card's toolchain."""
    load_kernel()
    return _fns["smem"](("f32", "chunk", "out").index(kernel), n, p, L)


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
    if x.dtype == torch.bfloat16:
        if n % 16 or not 16 <= n <= MAX_STATE_DIM:
            raise ValueError(f"d_state {n} is not a multiple of 16 in "
                             f"[16, {MAX_STATE_DIM}]")
        es = x.element_size()
        for name, t in (("x", x), ("B", B), ("C", C)):
            if t.data_ptr() % 16 or (t.stride(0) * es) % 16 \
                    or (t.stride(1) * es) % 16:
                raise ValueError(f"{name}'s rows must start on 16-byte "
                                 "boundaries (pointer and batch/sequence "
                                 "strides) for the 16-byte copies")


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
    plan = kernel_plan(b, s, h, p, g, n, chunk, x.dtype)
    for name, k in plan["kernels"].items():
        if k["smem"] > MAX_SMEM_BYTES:
            raise ValueError(f"d_state {n}, head dim {p}, chunk {L} need "
                             f"{k['smem']} bytes of shared memory in the "
                             f"{name} kernel, over {MAX_SMEM_BYTES}")
    fn = load_kernel()
    scratch = [None] * 3
    if x.dtype == torch.bfloat16:
        nc, Lt = plan["nc"], plan["tiles"] * TILE
        dev, f32 = x.device, torch.float32
        scratch = [torch.empty((b, h, s), dtype=f32, device=dev),
                   torch.empty((b, nc, g, Lt, Lt), dtype=f32, device=dev),
                   torch.empty((3, b, nc, h, n, p), dtype=x.dtype,
                               device=dev)]
    launch.run(fn, "ssd", x.device, x.dtype, x.data_ptr(), dt.data_ptr(),
               A.data_ptr(), B.data_ptr(), C.data_ptr(),
               initial_state.data_ptr() if initial_state is not None
               else None, y.data_ptr(), state.data_ptr(),
               *[t.data_ptr() if t is not None else None for t in scratch],
               b, s, h, p, g, n, L, x.stride(0), x.stride(1), B.stride(0),
               B.stride(1), C.stride(0), C.stride(1))
    ssd.launches += 1
    return y, state


ssd.launches = 0
