"""Plain PyTorch versions of paged attention: chunked prefill and decode.

Compute what ``repro.kernels.paged_attention.ref`` computes: each row's
pages are gathered in table order into a contiguous view, then a masked
softmax runs with per-row offsets and valid lengths. The wrappers in
``ops`` take these for CPU tensors; on the card they are what the CUDA
kernels are held against. Float8 pools are upcast as they are read (the
gathered pages widened to float32, exactly), as the reference's kernels
and paths upcast them. In the prefill form ``NEG_INF`` stays -1e30 (not
-inf) and the denominator keeps its 1e-30 floor, so fully padded rows give
finite garbage and never NaN; the decode form masks with -inf, as the
reference's does, and needs ``lens >= 1``.

``paged_attention_split_ref`` and ``paged_prefill_attention_tiled_ref`` are
the walks the CUDA kernels run, in float32: key ranges with per-range
partials merged in order (K2, and K1 at C = 1: at float32 q ranges of whole
pages from the shapes, on the CUDA cores; at bf16 q ranges of whole 64-key
tiles cut from each row's own length (``split_ranges``), walked with four
warps' online softmax in log2 units and P rounded before P.V, on the tensor
cores), and 64-row M tiles over key tiles of whole pages with an online
softmax in log2 units and P optionally rounded before P.V (K1 at C > 1).
The kernels are held to them at tolerances tighter than to the plain
versions."""
from __future__ import annotations

import math

import torch

from repro_torch.device import bits
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_split_ref
from repro_torch.kernels.flash_attention.ref import BLOCK_M, key_tile
from repro_torch.kernels.gqa import group_heads, ungroup_heads

NEG_INF = -1e30
# the tensor-core split decode (bf16 q at C = 1): keys per tile (whole
# pages), warps of a block (each takes its own 16 keys of every tile), and
# q-heads per M tile
SPLIT_KEY_TILE = 64
SPLIT_WARPS = 4
SPLIT_M_ROWS = 16


def gather_pages(pool: torch.Tensor, page_tables: torch.Tensor):
    """pool: (nb, blk, hkv, d); page_tables: (b, npages) ->
    (b, npages*blk, hkv, d) contiguous per-row view (position order), in
    the pool's dtype (an fp8 pool's pages gathered as bits)."""
    b, npages = page_tables.shape
    blk, hkv, d = pool.shape[1:]
    return bits(pool)[page_tables.long()].view(pool.dtype).reshape(
        b, npages * blk, hkv, d)


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


def split_ranges(lens, n_split: int, S: int):
    """(k_lo, k_hi), each (b, n_split) int64: the keys [k_lo, k_hi) of each
    row's ranges as the tensor-core split decode cuts them on the device.
    The row's length (clamped to [0, S]) in whole ``SPLIT_KEY_TILE`` tiles
    is cut into ``n_split`` ranges of ceil(tiles / n_split) tiles, in order;
    the last range ends at the length, and ranges past it are empty
    (k_hi <= k_lo)."""
    tile = SPLIT_KEY_TILE
    lens = torch.clamp(torch.as_tensor(lens).long(), 0, S)
    per = (-(-lens // tile) + n_split - 1) // n_split
    k_lo = (torch.arange(n_split, device=lens.device)[None]
            * per[:, None] * tile)
    k_hi = torch.minimum(k_lo + per[:, None] * tile, lens[:, None])
    return k_lo, k_hi


def _split_mma_walk(q, k, v, lens, n_split: int, scale, pairing, p_dtype):
    """The tensor-core split decode over the gathered pages k (b, S, hkv,
    d), v (b, S, hkv, dv), in float32: per (row, range of
    ``split_ranges``), key tiles of ``SPLIT_KEY_TILE``, warp w walking keys
    16 w .. 16 w + 15 of each with its own online softmax in log2 units
    (keys past the range at -inf and their values zero, as the kernel's
    copy fills them), P rounded to ``p_dtype`` before P.V and the sum
    taking P unrounded; the warps that saw a key merged in warp order, then
    the ranges' partials in range order. Returns (b, hq, dv) float32."""
    b, S, hkv, d = k.shape
    dv = v.shape[-1]
    tile, warps = SPLIT_KEY_TILE, SPLIT_WARPS
    scale_log2 = scale * math.log2(math.e)
    dev = q.device
    qg = group_heads(q[:, None], hkv, pairing)[:, 0].float()  # (b, hkv, g, d)
    g = qg.shape[2]
    kf = k.permute(0, 2, 1, 3).float()                         # (b, hkv, S, d)
    vf = v.permute(0, 2, 1, 3).float()
    k_lo, k_hi = split_ranges(lens, n_split, S)
    n_tiles = -(-(k_hi - k_lo).clamp(min=0) // tile)          # (b, ranges)
    ms, ls, os = [], [], []
    for sp in range(k_lo.shape[1]):
        m = torch.full((b, hkv, g, warps), float("-inf"), device=dev)
        l = torch.zeros((b, hkv, g, warps), device=dev)
        acc = torch.zeros((b, hkv, g, warps, dv), device=dev)
        for j in range(int(n_tiles[:, sp].max())):
            kpos = (k_lo[:, sp, None] + j * tile
                    + torch.arange(tile, device=dev)[None])     # (b, tile)
            live = kpos < k_hi[:, sp, None]
            idx = torch.clamp(kpos, max=S - 1)[:, None, :, None]
            kt = torch.gather(kf, 2, idx.expand(b, hkv, tile, d))
            vt = torch.gather(vf, 2, idx.expand(b, hkv, tile, dv))
            vt = torch.where(live[:, None, :, None], vt, 0.)
            s = (qg @ kt.transpose(-1, -2)) * scale_log2     # (b, hkv, g, t)
            s = torch.where(live[:, None, None], s, float("-inf"))
            s = s.reshape(b, hkv, g, warps, tile // warps)
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(torch.isinf(m_new), 0., m_new)
            corr = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * corr + p.sum(-1)
            p = p.to(p_dtype).float()
            pv = torch.einsum("bhgwt,bhwtd->bhgwd", p,
                              vt.reshape(b, hkv, warps, tile // warps, dv))
            acc = acc * corr[..., None] + pv
            m = m_new
        # the block's merge of its warps: weights exp2(m_w - M) over the
        # warps with l_w > 0, in warp order
        M = torch.where(l > 0, m, float("-inf")).amax(-1)
        M = torch.where(torch.isinf(M), 0., M)
        w = torch.where(l > 0, torch.exp2(m - M[..., None]), 0.)
        ms.append(M)
        ls.append((w * l).sum(-1))
        os.append((w[..., None] * acc).sum(-2))
    out = _merge_ranges(ms, ls, os)                            # (b,hkv,g,dv)
    return ungroup_heads(out[:, None], pairing)[:, 0]


def paged_attention_split_ref(q, k_pool, v_pool, lens, page_tables, *,
                              split: int, scale=None,
                              pairing: str = "kv_major", p_dtype=None):
    """The split decode (K2, and K1 at C = 1) in plain PyTorch, in float32,
    with ``ops.decode_plan``'s ``split``. Without ``p_dtype`` (float32 q,
    the CUDA-core pass): each row's npages * blk keys cut into ranges of
    ``split`` keys, whole pages, one partial (m, l, o) per (row, q-head,
    range) over the range's keys below the row's length, merged in range
    order: K4's walk over the gathered pages. With ``p_dtype`` (bf16 q, the
    tensor cores; torch.float32 leaves P unrounded): ceil(tiles /
    ceil(split / 64)) ranges per row, cut from each row's own length
    (``split_ranges``), walked as ``_split_mma_walk`` says. Arguments and
    result as ``paged_attention_ref``; a row of length 0 gives zeros."""
    k = gather_pages(k_pool, page_tables)
    v = gather_pages(v_pool, page_tables)
    if p_dtype is None:
        return decode_attention_split_ref(q, k, v, lens, split=split,
                                          scale=scale, pairing=pairing)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    tiles = -(-k.shape[1] // SPLIT_KEY_TILE)
    per = -(-split // SPLIT_KEY_TILE)
    return _split_mma_walk(q, k, v, lens, -(-tiles // per), scale, pairing,
                           p_dtype).to(q.dtype)


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
    (``paged_attention_split_ref`` at length max(cache_lens + valids, 1),
    on the tensor cores where ``p_dtype`` is given). At C > 1 the
    tensor-core walk: the rows of each
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
            scale=scale, pairing=pairing, p_dtype=p_dtype)[:, None]
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
