"""Wrappers for paged attention: chunked prefill (K1) and decode (K2).

``paged_prefill_attention`` is the function the megastep calls in every
layer, and the legacy loop in every prefill chunk; ``paged_attention`` is
the legacy loop's decode. On CUDA tensors each launches the hand-written
kernels in ``csrc/paged_prefill_attention.cu`` (built with nvcc at first
use) or raises; neither falls back. On CPU tensors each runs its plain
version in ``ref``. Each call that launches adds one to the wrapper's own
``launches`` count; a call of two passes (a split's partials, then their
merge) counts once.

Which kernel a call takes follows from its shapes alone (``kernel_plan``):
K2, and K1 at C = 1, split the keys over the pages (``decode_plan``), the
same kernel and plan for both, so K2 with ``lens = cache_lens + 1`` equals
K1 bit for bit on rows with ``valids = 1``; K1 at C > 1 runs 64-row tiles on
the tensor cores in bf16, their key range split where the tiles alone
leave SMs idle (``prefill_plan``), and the warp-per-row walk in float32.

``paged_prefill_attention_contig`` is the gathered-view twin (the reference's
``paged_prefill_attention_contig``): the same kernel over a contiguous
per-row view, reshaped into a pool whose page table is ``b*npages + j``.
Its output must equal the paged call's bit for bit, which pins the page
walk apart from float associativity.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention.ref import BLOCK_M, key_tile
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

SOURCE = (Path(__file__).resolve().parent / "csrc"
          / "paged_prefill_attention.cu")
BLOCK_SIZES = (8, 16)      # the kernel's page sizes
# C entry point -> (pointers, ints before scale, ints after scale)
_SIGNATURES = {"paged_prefill_attention": (9, 9, 1),
               "paged_decode_attention": (9, 8, 1)}
_fns: dict = {}


def load_kernel(name: str = "paged_prefill_attention"):
    """Build (if needed) and load the kernel; returns the C entry point
    ``name`` with its ctypes signature set. The handle is kept after the
    first call: resolving the library again costs more host time than a
    launch."""
    if name not in _fns:
        _fns[name] = launch.bind(SOURCE, name, *_SIGNATURES[name])
    return _fns[name]


@functools.lru_cache(maxsize=256)   # every launch asks; the shapes are few
def decode_plan(npages: int, blk: int, b: int, hq: int, hkv: int, d: int,
                dv: int, es: int, n_sm: int):
    """(split, n_split) of the split decode (K2; K1 at C = 1): ranges of
    whole pages, enough for b * hkv * n_split blocks to fill ``n_sm`` SMs.
    Shapes only, never the lengths."""
    limit = da._max_split(hq // hkv, d, dv, es, align=blk, id_bytes=4)
    return da.split_plan(npages * blk, b, hkv, n_sm, limit, align=blk)


@functools.lru_cache(maxsize=256)
def prefill_plan(npages: int, blk: int, b: int, C: int, hq: int, hkv: int,
                 d: int, dv: int, n_sm: int):
    """(split, n_split) of the tensor-core prefill (K1 bf16, C > 1): where
    its b * hkv * ceil(C g / 64) M tiles fill fewer than ``n_sm`` SMs, each
    tile's keys are cut into ranges of whole key tiles (``key_tile``: 32 or
    64 keys, whole pages); otherwise one range of all npages * blk keys.
    Shapes only, never the lengths."""
    n_mt = -(-C * (hq // hkv) // BLOCK_M)
    S = npages * blk
    return da.split_plan(S, b * n_mt, hkv, n_sm, S, align=key_tile(d, dv))


def kernel_plan(q, k_pool, v_pool, page_tables) -> dict:
    """The kernel a CUDA call with these shapes runs, its key ranges and
    its grids (pass 1, then the merge where there is one)."""
    b, C, hq, d = q.shape
    blk, hkv = k_pool.shape[1:3]
    dv = v_pool.shape[-1]
    npages = page_tables.shape[1]
    n_sm = da.sm_count(q.device)
    if C == 1:
        split, n_split = decode_plan(npages, blk, b, hq, hkv, d, dv,
                                     q.element_size(), n_sm)
        return {"route": "split", "split": split, "n_split": n_split,
                "blocks": [n_split * hkv * b, b * hq]}
    if q.dtype != torch.bfloat16:
        rows = C * (hq // hkv)
        return {"route": "walk", "split": npages * blk, "n_split": 1,
                "blocks": [-(-rows // 8) * hkv * b]}
    split, n_split = prefill_plan(npages, blk, b, C, hq, hkv, d, dv, n_sm)
    n_mt = -(-C * (hq // hkv) // BLOCK_M)
    blocks = [n_mt * n_split * hkv * b] + ([b * C * hq] if n_split > 1
                                          else [])
    return {"route": "tensor_cores", "split": split, "n_split": n_split,
            "key_tile": key_tile(d, dv), "blocks": blocks}


def _check_pools(q, k_pool, v_pool, page_tables, ints: dict):
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    blk, hkv, dk = k_pool.shape[1:]
    dv = v_pool.shape[-1]
    launch.check_inputs({"q": q, "k_pool": k_pool, "v_pool": v_pool},
                        {**ints, "page_tables": page_tables})
    if dk != d or v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    launch.check_heads(hq, hkv, d, dv, k_pool, v_pool)
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (cp.async staging)")
    if blk not in BLOCK_SIZES:
        raise ValueError(f"block size {blk} not in {BLOCK_SIZES}")
    if any(t.shape != (b,) for t in ints.values()) \
            or page_tables.ndim != 2 or page_tables.shape[0] != b \
            or page_tables.shape[1] < 1:
        raise ValueError(f"{'/'.join(ints)} must be (b,) and page_tables "
                         "(b, npages >= 1)")


def _workspace(q, R: int, n_split: int, dv: int):
    """Pointers to the f32 partials of R output rows per batch row, in one
    allocation (kept alive by the returned tensor): o (b, R, n_split, dv),
    then (m, l) (b, R, n_split, 2)."""
    n_o = q.shape[0] * R * n_split * dv
    ws = torch.empty(n_o + n_o // dv * 2, dtype=torch.float32,
                     device=q.device)
    return ws, ws.data_ptr(), ws.data_ptr() + 4 * n_o


def _split_decode(q, k_pool, v_pool, lens, valids, page_tables, scale,
                  pairing, plan):
    """Launch the split decode on q (b, 1, hq, d); ``valids`` None for K2."""
    b, _, hq, d = q.shape
    blk, hkv = k_pool.shape[1:3]
    dv = v_pool.shape[-1]
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    _ws, ws_o, ws_ml = _workspace(q, hq, plan["n_split"], dv)
    launch.run(load_kernel("paged_decode_attention"), "paged_attention",
               q.device, q.dtype, q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), lens.data_ptr(),
               None if valids is None else valids.data_ptr(),
               page_tables.data_ptr(), out.data_ptr(), ws_o, ws_ml, b, hq,
               hkv, d, dv, blk, page_tables.shape[1], plan["split"],
               float(scale), launch.PAIRINGS[pairing])
    return out


def paged_prefill_attention(q, k_pool, v_pool, cache_lens, valids,
                            page_tables, *, scale=None,
                            pairing: str = "kv_major"):
    """q: (b, C, hq, d) mixed prefill/decode rows; k_pool/v_pool:
    (nb, blk, hkv, d|dv); cache_lens/valids: (b,) int32; page_tables:
    (b, npages) int32 block ids in position order, entries past the live
    length pointing at valid blocks (the null block 0). ``pairing`` as in
    ``ref.paged_prefill_attention_ref``. Returns (b, C, hq, dv) in q's
    dtype. CUDA tensors launch a kernel (``kernel_plan`` says which), CPU
    tensors take the plain version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pool, v_pool, cache_lens,
                                           valids, page_tables, scale=scale,
                                           pairing=pairing)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    _check_pools(q, k_pool, v_pool, page_tables,
                 {"cache_lens": cache_lens, "valids": valids})
    b, C, hq, d = q.shape
    dv = v_pool.shape[-1]
    if b == 0 or C == 0:
        return torch.empty((b, C, hq, dv), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    plan = kernel_plan(q, k_pool, v_pool, page_tables)
    if plan["route"] == "split":
        out = _split_decode(q, k_pool, v_pool, cache_lens, valids,
                            page_tables, scale, pairing, plan)
    else:
        out = torch.empty((b, C, hq, dv), dtype=q.dtype, device=q.device)
        _ws, ws_o, ws_ml = (_workspace(q, C * hq, plan["n_split"], dv)
                            if plan["n_split"] > 1 else (None, None, None))
        launch.run(load_kernel(), "paged_prefill_attention", q.device,
                   q.dtype, q.data_ptr(), k_pool.data_ptr(),
                   v_pool.data_ptr(), cache_lens.data_ptr(),
                   valids.data_ptr(), page_tables.data_ptr(),
                   out.data_ptr(), ws_o, ws_ml, b, C, hq, k_pool.shape[2],
                   d, dv, k_pool.shape[1], page_tables.shape[1],
                   plan["split"], float(scale), launch.PAIRINGS[pairing])
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def paged_attention(q, k_pool, v_pool, lens, page_tables, *, scale=None,
                    pairing: str = "kv_major"):
    """Paged decode. q: (b, 1, hq, d), one query per row; pools as for
    ``paged_prefill_attention``; lens: (b,) int32, row b sees keys
    ``< lens[b]`` (none at 0: zeros). Returns (b, 1, hq, dv) in q's dtype.
    CUDA tensors launch the split decode (K2), CPU tensors take the plain
    version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return paged_attention_ref(q[:, 0], k_pool, v_pool, lens,
                                   page_tables, scale=scale,
                                   pairing=pairing)[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (b, 1, hq, d), got {tuple(q.shape)}")
    _check_pools(q, k_pool, v_pool, page_tables, {"lens": lens})
    b, _, hq, d = q.shape
    if b == 0:
        return torch.empty((b, 1, hq, v_pool.shape[-1]), dtype=q.dtype,
                           device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = _split_decode(q, k_pool, v_pool, lens, None, page_tables, scale,
                        pairing, kernel_plan(q, k_pool, v_pool, page_tables))
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_prefill_attention_contig(q, k_contig, v_contig, cache_lens, valids,
                                   page_tables, *, scale=None,
                                   pairing: str = "kv_major"):
    """The same kernel over a contiguous (b, npages*blk, hkv, d|dv) view
    (e.g. ``ref.gather_pages``): the view is reshaped into a pool of
    b*npages blocks and row b reads block ``b*npages + j`` as its page j.
    ``page_tables`` only supplies npages, so the call has the paged one's
    shapes, kernel and plan."""
    b, npages = page_tables.shape
    S, hkv, d = k_contig.shape[1:]
    blk = S // npages
    k_pool = k_contig.reshape(b * npages, blk, hkv, d)
    v_pool = v_contig.reshape(b * npages, blk, hkv, v_contig.shape[-1])
    table = torch.arange(b * npages, dtype=torch.int32,
                         device=page_tables.device).reshape(b, npages)
    return paged_prefill_attention(q, k_pool, v_pool, cache_lens, valids,
                                   table, scale=scale, pairing=pairing)
