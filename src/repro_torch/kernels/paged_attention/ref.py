"""Plain PyTorch versions of paged attention: chunked prefill and decode.

Compute what ``repro.kernels.paged_attention.ref`` computes: each row's
pages are gathered in table order into a contiguous view, then a masked
softmax runs with per-row offsets and valid lengths. The wrappers in
``ops`` take these for CPU tensors; on the card they are what the CUDA
kernels are held against. In the prefill form ``NEG_INF`` stays -1e30 (not
-inf) and the denominator keeps its 1e-30 floor, so fully padded rows give
finite garbage and never NaN; the decode form masks with -inf, as the
reference's does, and needs ``lens >= 1``."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gqa import group_heads, ungroup_heads

NEG_INF = -1e30


def gather_pages(pool: torch.Tensor, page_tables: torch.Tensor):
    """pool: (nb, blk, hkv, d); page_tables: (b, npages) ->
    (b, npages*blk, hkv, d) contiguous per-row view (position order)."""
    b, npages = page_tables.shape
    blk, hkv, d = pool.shape[1:]
    return pool[page_tables.long()].reshape(b, npages * blk, hkv, d)


def paged_attention_ref(q, k_pool, v_pool, lens, page_tables, *, scale=None,
                        pairing: str = "kv_major"):
    """Paged decode. q: (b, hq, d); pools: (nb, blk, hkv, d|dv); lens: (b,)
    int32, row b sees keys ``< lens[b]``; page_tables: (b, npages) int32.
    ``pairing`` as in ``repro_torch.kernels.gqa``. Returns (b, hq, dv)
    in q's dtype; the math runs in float32."""
    hkv = k_pool.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k = gather_pages(k_pool, page_tables)            # (b, S, hkv, d)
    v = gather_pages(v_pool, page_tables)
    qg = group_heads(q[:, None], hkv, pairing)       # (b, 1, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] < lens.long()[:, None]      # (b, S)
    s = s.masked_fill(~mask[:, None, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ungroup_heads(o, pairing)[:, 0].to(q.dtype)


def _mixed_mask(C: int, S: int, cache_lens, valids):
    """(b, C, S) bool mask: position ``i`` of row ``b`` sees key ``k`` iff
    ``k <= cache_lens[b] + i`` and ``k < max(cache_lens[b] + valids[b], 1)``
    (the clamp keeps one null key for inactive rows)."""
    dev = cache_lens.device
    cache_lens = cache_lens.long()
    kpos = torch.arange(S, device=dev)[None, None, :]
    qpos = (cache_lens[:, None, None]
            + torch.arange(C, device=dev)[None, :, None])
    kv_len = torch.clamp(cache_lens + valids.long(), min=1)[:, None, None]
    return (kpos <= qpos) & (kpos < kv_len)


def paged_prefill_attention_ref(q, k_pool, v_pool, cache_lens, valids,
                                page_tables, *, scale=None,
                                pairing: str = "kv_major"):
    """q: (b, C, hq, d); pools: (nb, blk, hkv, d|dv); cache_lens/valids:
    (b,) int32; page_tables: (b, npages) int32. ``pairing`` picks the kv
    head q-head h reads: "kv_major" (h // g) or "g_major" (h % hkv), see
    ``repro_torch.kernels.gqa``.
    Returns (b, C, hq, dv) in q's dtype; the math runs in float32."""
    C, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = gather_pages(k_pool, page_tables)            # (b, S, hkv, d)
    v = gather_pages(v_pool, page_tables)
    S = k.shape[1]
    qg = group_heads(q, k_pool.shape[2], pairing)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = _mixed_mask(C, S, cache_lens, valids)     # (b, C, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ungroup_heads(o, pairing).to(q.dtype)
