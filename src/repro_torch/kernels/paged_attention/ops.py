"""Wrappers for paged attention: chunked prefill (K1) and decode (K2).

``paged_prefill_attention`` is the function the megastep calls in every
layer, and the legacy loop in every prefill chunk; ``paged_attention`` is
the legacy loop's decode. On CUDA tensors each launches its entry point of
the hand-written kernel in ``csrc/paged_prefill_attention.cu`` (built with
nvcc at first use) or raises; neither falls back. On CPU tensors each runs
its plain version in ``ref``. Each launch adds one to the wrapper's own
``launches`` count.

``paged_prefill_attention_contig`` is the gathered-view twin (the reference's
``paged_prefill_attention_contig``): the same kernel over a contiguous
per-row view, reshaped into a pool whose page table is ``b*npages + j``.
Its output must equal the paged call's bit for bit, which pins the page
walk apart from float associativity.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_ref)

SOURCE = (Path(__file__).resolve().parent / "csrc"
          / "paged_prefill_attention.cu")
BLOCK_SIZES = (8, 16)      # the kernel's instantiations of the page size
# C entry point -> (pointers, ints before scale, ints after scale)
_SIGNATURES = {"paged_prefill_attention": (7, 8, 1),
               "paged_decode_attention": (6, 7, 1)}
_fns: dict = {}


def load_kernel(name: str = "paged_prefill_attention"):
    """Build (if needed) and load the kernel; returns the C entry point
    ``name`` with its ctypes signature set. The handle is kept after the
    first call: resolving the library again costs more host time than a
    launch."""
    if name not in _fns:
        _fns[name] = launch.bind(SOURCE, name, *_SIGNATURES[name])
    return _fns[name]


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
    if blk not in BLOCK_SIZES:
        raise ValueError(f"block size {blk} not in {BLOCK_SIZES}")
    if any(t.shape != (b,) for t in ints.values()) \
            or page_tables.ndim != 2 or page_tables.shape[0] != b \
            or page_tables.shape[1] < 1:
        raise ValueError(f"{'/'.join(ints)} must be (b,) and page_tables "
                         "(b, npages >= 1)")
    return b, hq, hkv, d, dv, blk, page_tables.shape[1]


def paged_prefill_attention(q, k_pool, v_pool, cache_lens, valids,
                            page_tables, *, scale=None,
                            pairing: str = "kv_major"):
    """q: (b, C, hq, d) mixed prefill/decode rows; k_pool/v_pool:
    (nb, blk, hkv, d|dv); cache_lens/valids: (b,) int32; page_tables:
    (b, npages) int32 block ids in position order, entries past the live
    length pointing at valid blocks (the null block 0). ``pairing`` as in
    ``ref.paged_prefill_attention_ref``. Returns (b, C, hq, dv) in q's
    dtype. CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pool, v_pool, cache_lens,
                                           valids, page_tables, scale=scale,
                                           pairing=pairing)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    b, hq, hkv, d, dv, blk, npages = _check_pools(
        q, k_pool, v_pool, page_tables,
        {"cache_lens": cache_lens, "valids": valids})
    C = q.shape[1]
    out = torch.empty((b, C, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0 or C == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch.run(load_kernel(), "paged_prefill_attention", q.device, q.dtype,
               q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               cache_lens.data_ptr(), valids.data_ptr(),
               page_tables.data_ptr(), out.data_ptr(), b, C, hq, hkv, d, dv,
               blk, npages, float(scale), launch.PAIRINGS[pairing])
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def paged_attention(q, k_pool, v_pool, lens, page_tables, *, scale=None,
                    pairing: str = "kv_major"):
    """Paged decode. q: (b, 1, hq, d), one query per row; pools as for
    ``paged_prefill_attention``; lens: (b,) int32, row b sees keys
    ``< lens[b]``. Returns (b, 1, hq, dv) in q's dtype. CUDA tensors launch
    the kernel (K2), CPU tensors take the plain version."""
    launch.check_pairing(pairing)
    if q.device.type == "cpu":
        return paged_attention_ref(q[:, 0], k_pool, v_pool, lens,
                                   page_tables, scale=scale,
                                   pairing=pairing)[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (b, 1, hq, d), got {tuple(q.shape)}")
    b, hq, hkv, d, dv, blk, npages = _check_pools(
        q, k_pool, v_pool, page_tables, {"lens": lens})
    out = torch.empty((b, 1, hq, dv), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch.run(load_kernel("paged_decode_attention"), "paged_attention",
               q.device, q.dtype, q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), lens.data_ptr(), page_tables.data_ptr(),
               out.data_ptr(), b, hq, hkv, d, dv, blk, npages, float(scale),
               launch.PAIRINGS[pairing])
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_prefill_attention_contig(q, k_contig, v_contig, cache_lens, valids,
                                   page_tables, *, scale=None,
                                   pairing: str = "kv_major"):
    """The same kernel over a contiguous (b, npages*blk, hkv, d|dv) view
    (e.g. ``ref.gather_pages``): the view is reshaped into a pool of
    b*npages blocks and row b reads block ``b*npages + j`` as its page j.
    ``page_tables`` only supplies npages."""
    b, npages = page_tables.shape
    S, hkv, d = k_contig.shape[1:]
    blk = S // npages
    k_pool = k_contig.reshape(b * npages, blk, hkv, d)
    v_pool = v_contig.reshape(b * npages, blk, hkv, v_contig.shape[-1])
    table = torch.arange(b * npages, dtype=torch.int32,
                         device=page_tables.device).reshape(b, npages)
    return paged_prefill_attention(q, k_pool, v_pool, cache_lens, valids,
                                   table, scale=scale, pairing=pairing)
