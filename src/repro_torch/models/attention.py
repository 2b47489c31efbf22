"""GQA/MQA attention blocks, computing what ``repro.models.attention``
computes on its executed path for the dense GQA family:

  * ``gqa_full`` — a full sequence (``forward``, dense prefill), through
    ``layers.attention`` (kernel K3 on the card; a sliding window takes the
    plain path, as in the reference);
  * ``gqa_decode`` — one token against a contiguous cache at a scalar or
    per-slot length (kernel K4);
  * ``gqa_decode_paged`` / ``gqa_prefill_chunk_paged`` — the legacy paged
    loop's decode (K2) and one sequence's prefill chunk (K1);
  * ``gqa_mixed_step_paged`` — the megastep's mixed batch (K1);
  * ``gqa_decode_ring`` — the hybrid's shared block at decode, one token
    against a ring-buffer cache (K4).

``use_pallas`` is not read: a CUDA tensor launches the Hopper kernel, a CPU
tensor takes its plain version. Caches and pools are updated in place
where the reference returns new donated buffers. ``pairing`` follows
``cfg.gqa_mode`` everywhere, as the reference's executed path does."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models.layers import _init, apply_rope, attention, \
    rope_tables, simple_attention


def init_gqa(cfg: ModelConfig, *, generator, device, dtype=torch.float32):
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"wq": _init((d, hq * hd), **kw), "wk": _init((d, hkv * hd), **kw),
            "wv": _init((d, hkv * hd), **kw), "wo": _init((hq * hd, d), **kw)}


def _pairing(cfg: ModelConfig) -> str:
    return "g_major" if cfg.gqa_mode == "tiled" else "kv_major"


def _qkv(params, x, pos, cfg: ModelConfig):
    """x: (b, s, d) -> q (b, s, hq, hd), k/v (b, s, hkv, hd), rotated at
    ``pos`` ((s,) shared or (b, s) per row)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, hq, hd)
    k = (x @ params["wk"]).reshape(b, s, hkv, hd)
    v = (x @ params["wv"]).reshape(b, s, hkv, hd)
    if cfg.rotary_pct > 0:
        cos, sin = rope_tables(pos, int(hd * cfg.rotary_pct), cfg.rope_theta)
        q = apply_rope(q, cos, sin, cfg.rotary_pct)
        k = apply_rope(k, cos, sin, cfg.rotary_pct)
    return q, k, v


def gqa_full(params, x, cfg: ModelConfig, *, window: int = 0,
             return_kv=False):
    """x: (b, s, d) -> (b, s, d) causal attention output (and the rotated
    (k, v) when ``return_kv``), positions 0..s-1, each query seeing the
    last ``window`` keys (0: all)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, torch.arange(s, device=x.device), cfg)
    o = attention(q, k, v, causal=True, window=window,
                  gqa_mode=cfg.gqa_mode)
    out = o.reshape(b, s, -1) @ params["wo"]
    return (out, (k, v)) if return_kv else out


def gqa_decode(params, x, cache_k, cache_v, cache_len, cfg: ModelConfig):
    """x: (b, 1, d); cache_k/cache_v: (b, S, hkv, hd), this token's K/V
    written IN PLACE at ``cache_len``; returns the (b, 1, d) output.

    cache_len is an int or 0-d tensor (lockstep decode) or a (b,) int32
    tensor (per-slot depths of the dense engine). Both attend with
    ``kv_len = cache_len + 1`` through the decode kernel (K4) on the card.
    A per-slot write past the cache (an idle slot left at a full length)
    is dropped, as the reference's scatter drops it."""
    b = x.shape[0]
    S = cache_k.shape[1]
    per_slot = torch.is_tensor(cache_len) and cache_len.ndim == 1
    pos = (cache_len.reshape(b, 1) if per_slot
           else torch.as_tensor(cache_len, device=x.device).reshape(1))
    q, k, v = _qkv(params, x, pos, cfg)
    if per_slot:
        rows = torch.arange(b, device=x.device)
        idx = torch.clamp(cache_len.long(), max=S - 1)
        keep = (cache_len < S)[:, None, None]
        cache_k[rows, idx] = torch.where(keep, k[:, 0].to(cache_k.dtype),
                                         cache_k[rows, idx])
        cache_v[rows, idx] = torch.where(keep, v[:, 0].to(cache_v.dtype),
                                         cache_v[rows, idx])
        kv_len = (cache_len + 1).to(torch.int32)
    else:
        cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
        cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
        kv_len = int(cache_len) + 1
    o = da.decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                            pairing=_pairing(cfg))
    return o.reshape(b, 1, -1) @ params["wo"]


def gqa_decode_paged(params, x, k_pool, v_pool, page_tables, cache_len,
                     cfg: ModelConfig):
    """Paged decode, one token per sequence. x: (b, 1, d); k_pool/v_pool:
    (num_blocks, blk, hkv, hd), one layer's view of the pools, UPDATED IN
    PLACE; page_tables: (b, npages) int32, null-padded; cache_len: (b,)
    int32 lengths before this token. The token's K/V goes to block
    ``page_tables[b, cache_len // blk]`` at ``cache_len % blk`` (inactive
    rows, all-null tables, write into the null block), then the row attends
    to ``cache_len + 1`` keys through the paged decode kernel (K2)."""
    b = x.shape[0]
    blk = k_pool.shape[1]
    q, k, v = _qkv(params, x, cache_len.reshape(b, 1), cfg)
    rows = torch.arange(b, device=x.device)
    bids = page_tables[rows, (cache_len // blk).long()].long()
    offs = (cache_len % blk).long()
    k_pool[bids, offs] = k[:, 0].to(k_pool.dtype)
    v_pool[bids, offs] = v[:, 0].to(v_pool.dtype)
    o = pa.paged_attention(q.contiguous(), k_pool, v_pool,
                           (cache_len + 1).to(torch.int32), page_tables,
                           pairing=_pairing(cfg))
    return o.reshape(b, 1, -1) @ params["wo"]


def gqa_prefill_chunk_paged(params, x, k_pool, v_pool, page_table, cache_len,
                            valid, cfg: ModelConfig):
    """Chunked prefill of ONE sequence over the paged pools. x: (1, C, d);
    pools as for ``gqa_decode_paged``, UPDATED IN PLACE; page_table:
    (npages,) int32; cache_len/valid: ints, the tokens resident before the
    chunk and how many of its C positions are real (padding writes go to
    the null block). The reference attends over gathered pages with
    ``q_offset = cache_len`` and ``kv_len = cache_len + valid``; that is
    the chunked-prefill kernel's mask (K1) at b = 1, which runs here."""
    _, C, _ = x.shape
    blk = k_pool.shape[1]
    npages = page_table.shape[0]
    dev = x.device
    pos = cache_len + torch.arange(C, device=dev)
    q, k, v = _qkv(params, x, pos, cfg)
    live = torch.arange(C, device=dev) < valid
    page_idx = torch.clamp(pos // blk, 0, npages - 1)
    bids = torch.where(live, page_table[page_idx],
                       torch.zeros_like(page_table[:1])).long()
    offs = (pos % blk).long()
    k_pool[bids, offs] = k[0].to(k_pool.dtype)
    v_pool[bids, offs] = v[0].to(v_pool.dtype)
    lens = torch.tensor([cache_len], dtype=torch.int32, device=dev)
    valids = torch.tensor([valid], dtype=torch.int32, device=dev)
    o = pa.paged_prefill_attention(q.contiguous(), k_pool, v_pool, lens,
                                   valids, page_table[None],
                                   pairing=_pairing(cfg))
    return o.reshape(1, C, -1) @ params["wo"]


def gqa_mixed_step_paged(params, x, k_pool, v_pool, page_tables, cache_lens,
                         valids, cfg: ModelConfig):
    """One layer's attention over a mixed batch: every row of the (B, C)
    batch is a prefill chunk, decode rows carrying ``valids == 1``.

    x: (B, C, d); k_pool/v_pool: (num_blocks, blk, hkv, hd), one layer's
    view of the pools, UPDATED IN PLACE with this step's K/V (the reference
    returns new donated buffers instead); page_tables: (B, npages) int32,
    null-padded; cache_lens/valids: (B,) int32. Positions, scatter targets
    and the attention mask come from ``cache_lens``/``valids`` per row,
    never from C. Returns the (B, C, d) attention output."""
    b, C, _ = x.shape
    blk = k_pool.shape[1]
    npages = page_tables.shape[1]
    cols = torch.arange(C, device=x.device, dtype=torch.int32)
    pos = cache_lens[:, None] + cols[None, :]                   # (B, C)
    q, k, v = _qkv(params, x, pos, cfg)
    # scatter every row's chunk into its own blocks; padding positions and
    # inactive rows aim at the null block 0. Several of them may hit the
    # same slot of block 0, which is fine only because block 0 is never
    # read unmasked.
    live = cols[None, :] < valids[:, None]
    page_idx = torch.clamp(pos // blk, 0, npages - 1).long()
    bids = torch.where(live, torch.gather(page_tables, 1, page_idx),
                       torch.zeros_like(page_tables[:, :1]))
    offs = (pos % blk).long()
    k_pool.index_put_((bids.long(), offs), k.to(k_pool.dtype))
    v_pool.index_put_((bids.long(), offs), v.to(v_pool.dtype))
    o = pa.paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                   cache_lens, valids, page_tables,
                                   pairing=_pairing(cfg))
    return o.reshape(b, C, -1) @ params["wo"]


def gqa_decode_ring(params, x, cache_k, cache_v, cache_len: int,
                    cfg: ModelConfig):
    """Sliding-window decode against a ring-buffer cache (the hybrid's
    shared block). x: (b, 1, d); cache_k/cache_v: (b, W, hkv, hd), the
    entry of absolute position t at slot t % W; this token's K/V (rotated
    at position ``cache_len``) is written there IN PLACE. The token attends
    to the ``min(cache_len + 1, W)`` filled slots: all of them once the
    ring is full, in ring order, which a softmax does not see. On the card
    through the decode kernel (K4), which reads the ring in place; on the
    CPU through ``simple_attention``, as the reference does."""
    b = x.shape[0]
    w = cache_k.shape[1]
    cache_len = int(cache_len)
    q, k, v = _qkv(params, x, torch.tensor([cache_len], device=x.device),
                   cfg)
    write = cache_len % w
    cache_k[:, write] = k[:, 0].to(cache_k.dtype)
    cache_v[:, write] = v[:, 0].to(cache_v.dtype)
    kv_len = min(cache_len + 1, w)
    if x.device.type == "cuda":
        o = da.decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                                pairing=_pairing(cfg))
    else:
        o = simple_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                             causal=False, kv_len=kv_len,
                             pairing=_pairing(cfg))
    return o.reshape(b, 1, -1) @ params["wo"]
