"""Plain PyTorch versions of paged attention: chunked prefill and decode.

Compute what ``repro.kernels.paged_attention.ref`` computes: each row's
pages are gathered in table order into a contiguous view, then a masked
softmax runs with per-row offsets and valid lengths. The wrappers in
``ops`` take these for CPU tensors; on the card they are what the CUDA
kernels are held against. In the prefill form ``NEG_INF`` stays -1e30 (not
-inf) and the denominator keeps its 1e-30 floor, so fully padded rows give
finite garbage and never NaN; the decode form masks with -inf, as the
reference's does, and needs ``lens >= 1``.

``paged_attention_split_ref`` and ``paged_prefill_attention_tiled_ref`` are
the walks the CUDA kernels run, in float32: key ranges of whole pages with
per-range partials merged in order (K2, and K1 at C = 1), and 64-row M
tiles over key tiles of whole pages with an online softmax in log2 units
and P optionally rounded before P.V (K1 at C > 1). The kernels are held to
them at tolerances tighter than to the plain versions."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ref import \
    decode_attention_split_ref
from repro_torch.kernels.flash_attention.ref import BLOCK_M, key_tile
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


def paged_attention_split_ref(q, k_pool, v_pool, lens, page_tables, *,
                              split: int, scale=None,
                              pairing: str = "kv_major"):
    """The split decode (K2, and K1 at C = 1) in plain PyTorch, in float32:
    each row's npages * blk keys cut into ranges of ``split`` keys, whole
    pages (``ops.decode_plan`` gives the kernel's), one partial (m, l, o)
    per (row, q-head, range) over the range's keys below the row's length,
    merged in range order. Arguments and result as ``paged_attention_ref``;
    a row of length 0 gives zeros. The walk is K4's over the gathered
    pages."""
    return decode_attention_split_ref(
        q, gather_pages(k_pool, page_tables),
        gather_pages(v_pool, page_tables), lens, split=split, scale=scale,
        pairing=pairing)


def _merge_ranges(ms, ls, os):
    """The in-order merge of per-range partials in log2 units: weights
    exp2(m_s - M) over the ranges with l_s > 0 (exactly 0 elsewhere, with
    no -inf - -inf), the sum floored at 1e-30."""
    m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os)
    M = torch.where(l > 0, m, float("-inf")).amax(0)
    M = torch.where(torch.isinf(M), 0., M)
    w = torch.where(l > 0, torch.exp2(m - M), 0.)
    L = (w * l).sum(0)
    return (w[..., None] * o).sum(0) / torch.clamp(L, min=1e-30)[..., None]


def paged_prefill_attention_tiled_ref(q, k_pool, v_pool, cache_lens, valids,
                                      page_tables, *, split=None,
                                      scale=None, pairing: str = "kv_major",
                                      p_dtype=None):
    """K1's walks in plain PyTorch, in float32. At C = 1 the split decode
    (``paged_attention_split_ref`` at length max(cache_lens + valids, 1);
    ``p_dtype`` unused). At C > 1 the tensor-core walk: the rows of each
    (b, kv head), chunk positions x the g q-heads of that kv head, cut into
    M tiles of BLOCK_M; each M tile's visible keys (below kv_len, at most
    its last position) cut into ranges of ``split`` keys (None: one range),
    each walked in key tiles of ``key_tile(d, dv)`` keys with an online
    softmax in log2 units, rows past the range's last visible key zeroed as
    the kernel's copy zero-fills them; P rounded to ``p_dtype`` (None: not
    rounded) before P.V, the sum taking P unrounded; the ranges' partials
    merged in order. Arguments and result as
    ``paged_prefill_attention_ref``."""
    b, C, hq, d = q.shape
    blk, hkv = k_pool.shape[1:3]
    dv = v_pool.shape[-1]
    S = page_tables.shape[1] * blk
    if C == 1:
        lens = torch.clamp(cache_lens + valids, min=1).to(torch.int32)
        return paged_attention_split_ref(
            q[:, 0], k_pool, v_pool, lens, page_tables, split=split or S,
            scale=scale, pairing=pairing)[:, None]
    dev = q.device
    g = hq // hkv
    rows = C * g
    block_n = key_tile(d, dv)
    split = split or S
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    # (b, hkv, C * g, d): row r is position r // g, head r % g of the group
    qr = group_heads(q, hkv, pairing).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d).float()
    kf = gather_pages(k_pool, page_tables).permute(0, 2, 1, 3).float()
    vf = gather_pages(v_pool, page_tables).permute(0, 2, 1, 3).float()
    off = cache_lens.long()
    kv_lim = torch.clamp(torch.clamp(off + valids.long(), min=1), max=S)
    out = torch.empty((b, hkv, rows, dv), device=dev)
    for r0 in range(0, rows, BLOCK_M):
        r1 = min(r0 + BLOCK_M, rows)
        qpos = off[:, None] + torch.arange(r0, r1, device=dev) // g  # (b, m)
        kv_hi = torch.minimum(kv_lim, off + (r1 - 1) // g + 1)       # (b,)
        ms, ls, os = [], [], []
        for s0 in range(0, S, split):
            k_hi = torch.clamp(kv_hi, max=s0 + split)
            m = torch.full((b, hkv, r1 - r0), float("-inf"), device=dev)
            l = torch.zeros((b, hkv, r1 - r0), device=dev)
            acc = torch.zeros((b, hkv, r1 - r0, dv), device=dev)
            for k0 in range(s0, min(int(k_hi.max()), S), block_n):
                k1 = min(k0 + block_n, S)
                kpos = torch.arange(k0, k1, device=dev)
                live = kpos[None, :] < k_hi[:, None]                 # (b, t)
                seen = live[:, None, :] & (kpos[None, None, :]
                                           <= qpos[:, :, None])     # (b,m,t)
                s = qr[:, :, r0:r1] @ kf[:, :, k0:k1].transpose(-1, -2)
                s = torch.where(seen[:, None], s * scale_log2,
                                float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                base = torch.where(torch.isinf(m_new), 0., m_new)
                corr = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                l = l * corr + p.sum(-1)
                if p_dtype is not None:
                    p = p.to(p_dtype).float()
                v_t = torch.where(live[:, None, :, None], vf[:, :, k0:k1],
                                  0.)
                acc = acc * corr[..., None] + p @ v_t
                m = m_new
            ms.append(m)
            ls.append(l)
            os.append(acc)
        out[:, :, r0:r1] = _merge_ranges(ms, ls, os)
    o = out.reshape(b, hkv, C, g, dv).permute(0, 2, 1, 3, 4)
    return ungroup_heads(o, pairing).to(q.dtype)
