"""Attention blocks, computing what ``repro.models.attention`` computes on
its executed path: GQA/MQA/MHA with RoPE, and DeepSeek-V2's MLA.

  * ``gqa_full`` — a full sequence (``forward``, dense prefill), causal or
    not (the encoder), through ``layers.attention`` (kernel K3 on the card;
    a sliding window takes the plain path, as in the reference);
  * ``gqa_cross`` — queries against the encoder's precomputed K/V, not
    causal (K3 on the card, at every query length);
  * ``gqa_decode`` — one token against a contiguous cache at a scalar or
    per-slot length (kernel K4);
  * ``gqa_decode_paged`` / ``gqa_prefill_chunk_paged`` — the legacy paged
    loop's decode (K2) and one sequence's prefill chunk (K1);
  * ``gqa_mixed_step_paged`` — the megastep's mixed batch (K1), its
    projections over the (B, C) batch or over the flat token axis that
    ``flat_slots`` lays out;
  * ``gqa_decode_ring`` — the hybrid's shared block at decode, one token
    against a ring-buffer cache (K4);
  * ``mla_full`` — MLA over a full sequence, K/V decompressed per head
    (K3 at d = qk_nope + qk_rope, dv = v_head_dim);
  * ``mla_decode`` — MLA's absorbed decode over the latent
    (c_kv, k_rope) cache at a scalar length, plain products as the
    reference's are XLA einsums.

``use_pallas`` is not read: a CUDA tensor launches the Hopper kernel, a CPU
tensor takes its plain version. Caches and pools are updated in place
where the reference returns new donated buffers. ``pairing`` follows
``cfg.gqa_mode`` everywhere, as the reference's executed path does."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.device import bits, cast_to, runs_kernels
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models.layers import _init, apply_rope, attention, \
    rms_norm, rope_tables, simple_attention


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


def _write_pages(k_pool, v_pool, bids, offs, k, v):
    """k_pool[bids, offs] = k and v_pool[bids, offs] = v, in place.

    Padding positions and idle rows all aim at the null block 0, so some of
    its slots are written more than once, and torch leaves which write wins
    undefined (on the CPU as on the card). The reference's scatter applies
    its updates in order, so the last write in row-major order wins, and an
    MoE's idle rows read that content: their tokens are routed and take
    expert capacity from their batchmates. So every write to a slot carries
    the value of the last one (the largest index aiming at it), and any
    order gives the reference's content. The values are cast to the
    pools' dtype by the reference's rule (``device.cast_to``: an fp8
    overflow is NaN) and written as bits."""
    blk = k_pool.shape[1]
    flat = (bids.long() * blk + offs.long()).reshape(-1)
    n = flat.numel()
    last = torch.full((k_pool.shape[0] * blk,), -1, dtype=torch.long,
                      device=flat.device)
    last.scatter_reduce_(0, flat, torch.arange(n, device=flat.device), "amax")
    src = last[flat]
    k = k.reshape(n, *k.shape[-2:])[src].reshape(k.shape)
    v = v.reshape(n, *v.shape[-2:])[src].reshape(v.shape)
    for pool, new in ((k_pool, k), (v_pool, v)):
        bits(pool).index_put_((bids.long(), offs.long()),
                              bits(cast_to(new, pool.dtype)))


def gqa_full(params, x, cfg: ModelConfig, *, causal: bool = True,
             window: int = 0, return_kv=False):
    """x: (b, s, d) -> (b, s, d) attention output (and the rotated (k, v)
    when ``return_kv``), positions 0..s-1; causal, or every query seeing
    every key (the encoder); each query sees the last ``window`` keys (0:
    all)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, torch.arange(s, device=x.device), cfg)
    o = attention(q, k, v, causal=causal, window=window,
                  gqa_mode=cfg.gqa_mode)
    out = o.reshape(b, s, -1) @ params["wo"]
    return (out, (k, v)) if return_kv else out


def gqa_cross(params, x, kv, cfg: ModelConfig):
    """Cross-attention: x (b, s, d) queries (no RoPE) against ``kv`` =
    (k, v), each (b, s_enc, hkv, hd), precomputed from the encoder; every
    query sees every key."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    k, v = kv
    o = attention(q, k, v, causal=False, gqa_mode=cfg.gqa_mode)
    return o.reshape(b, s, -1) @ params["wo"]


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
    # written as bits, cast by the reference's rule (``device.cast_to``)
    news = [(bits(cache), bits(cast_to(new[:, 0], cache.dtype)))
            for cache, new in ((cache_k, k), (cache_v, v))]
    if per_slot:
        rows = torch.arange(b, device=x.device)
        idx = torch.clamp(cache_len.long(), max=S - 1)
        keep = (cache_len < S)[:, None, None]
        for cache, new in news:
            cache[rows, idx] = torch.where(keep, new, cache[rows, idx])
        kv_len = (cache_len + 1).to(torch.int32)
    else:
        for cache, new in news:
            cache[:, cache_len] = new
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
    _write_pages(k_pool, v_pool, bids, offs, k[:, 0], v[:, 0])
    o = pa.paged_attention(q.contiguous(), k_pool, v_pool,
                           (cache_len + 1).to(torch.int32), page_tables,
                           pairing=_pairing(cfg))
    return o.reshape(b, 1, -1) @ params["wo"]


def row_lengths(n, device) -> torch.Tensor:
    """``n`` as a (1,) int32 tensor on ``device``: an int is filled in on
    the device (no host-to-device copy, which a CUDA graph could not
    hold), a tensor of one element is viewed as (1,) and kept."""
    if isinstance(n, torch.Tensor):
        return n.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), n, dtype=torch.int32, device=device)


def gqa_prefill_chunk_paged(params, x, k_pool, v_pool, page_table, cache_len,
                            valid, cfg: ModelConfig):
    """Chunked prefill of ONE sequence over the paged pools. x: (1, C, d);
    pools as for ``gqa_decode_paged``, UPDATED IN PLACE; page_table:
    (npages,) int32; cache_len/valid: (1,) int32 device tensors (or ints),
    the tokens resident before the chunk and how many of its C positions
    are real (padding writes go to the null block). Positions, scatter
    targets and the mask are computed on the device, so the step may be
    captured with its lengths staged. The reference attends over gathered
    pages with ``q_offset = cache_len`` and ``kv_len = cache_len + valid``;
    that is the chunked-prefill kernel's mask (K1) at b = 1, which runs
    here."""
    _, C, _ = x.shape
    blk = k_pool.shape[1]
    npages = page_table.shape[0]
    dev = x.device
    lens = row_lengths(cache_len, dev)
    valids = row_lengths(valid, dev)
    cols = torch.arange(C, device=dev, dtype=torch.int32)
    pos = lens + cols                                           # (C,)
    q, k, v = _qkv(params, x, pos, cfg)
    live = cols < valids
    page_idx = torch.clamp(pos // blk, 0, npages - 1).long()
    bids = torch.where(live, page_table[page_idx],
                       torch.zeros_like(page_table[:1])).long()
    offs = (pos % blk).long()
    _write_pages(k_pool, v_pool, bids, offs, k[0], v[0])
    o = pa.paged_prefill_attention(q.contiguous(), k_pool, v_pool, lens,
                                   valids, page_table[None],
                                   pairing=_pairing(cfg))
    return o.reshape(1, C, -1) @ params["wo"]


@dataclasses.dataclass(frozen=True)
class FlatSlots:
    """The megastep's flat token axis: N slots that hold the real tokens of
    a (B, C) batch end to end, row after row (``flat_slots``). The slots
    past the last real token are spare: they compute what they compute,
    write zeros into the null block and are never read."""
    C: int
    row: torch.Tensor    # (N,) int64: the slot's row (spare: the last row)
    pos: torch.Tensor    # (N,) int32: its position, cache_lens[row] + column
    live: torch.Tensor   # (N,) bool: a real token
    idx: torch.Tensor    # (N,) int64: row * C + column; spare: B * C + slot
    last: torch.Tensor   # (B,) int64: each row's last slot

    def gather(self, t):
        """(B * C, ...) -> (N, ...): each slot's entry of a batch tensor (a
        spare slot reads the batch's last)."""
        return t[self.idx.clamp(max=t.shape[0] - 1)]


def flat_slots(cache_lens, valids, C: int, n: int) -> FlatSlots:
    """The map from ``n`` flat slots to the (B, C) batch, built on the
    device from ``valids`` alone (nothing read on the host, so a captured
    step replays it): an exclusive sum of ``valids`` gives each row's first
    slot, and a search over the inclusive sum each slot's row. ``n`` must
    be at least ``sum(valids)``; the engine's token budget keeps it so."""
    v = valids.long()
    ends = torch.cumsum(v, 0)
    slot = torch.arange(n, device=v.device)
    row = torch.searchsorted(ends, slot, right=True).clamp_(max=v.numel() - 1)
    col = slot - (ends - v)[row]
    live = slot < ends[-1]
    return FlatSlots(C, row, (cache_lens.long()[row] + col).to(torch.int32),
                     live, torch.where(live, row * C + col,
                                       v.numel() * C + slot),
                     (ends - 1).clamp(0, n - 1))


def gqa_mixed_step_paged(params, x, k_pool, v_pool, page_tables, cache_lens,
                         valids, cfg: ModelConfig,
                         flat: Optional[FlatSlots] = None):
    """One layer's attention over a mixed batch: every row of the (B, C)
    batch is a prefill chunk, decode rows carrying ``valids == 1``.

    x: (B, C, d); k_pool/v_pool: (num_blocks, blk, hkv, hd), one layer's
    view of the pools, UPDATED IN PLACE with this step's K/V (the reference
    returns new donated buffers instead); page_tables: (B, npages) int32,
    null-padded; cache_lens/valids: (B,) int32. Positions, scatter targets
    and the attention mask come from ``cache_lens``/``valids`` per row,
    never from C. Returns the (B, C, d) attention output.

    With ``flat``, x is (1, N, d) on the flat token axis and so is the
    output: the projections, rotary and ``wo`` run on the N slots, each
    slot's K/V is written from there, and only q is scattered into a
    (B, C) batch for K1, whose output is gathered back. The batch's padded
    positions are left unwritten: K1 reads each query row alone and their
    rows are never gathered."""
    if flat is not None:
        return _gqa_mixed_flat(params, x, k_pool, v_pool, page_tables,
                               cache_lens, valids, cfg, flat)
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
    _write_pages(k_pool, v_pool, bids, offs, k, v)
    o = pa.paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                   cache_lens, valids, page_tables,
                                   pairing=_pairing(cfg))
    return o.reshape(b, C, -1) @ params["wo"]


def _gqa_mixed_flat(params, x, k_pool, v_pool, page_tables, cache_lens,
                    valids, cfg: ModelConfig, flat: FlatSlots):
    B, npages = page_tables.shape
    BC = B * flat.C
    blk = k_pool.shape[1]
    q, k, v = _qkv(params, x, flat.pos[None], cfg)
    page_idx = torch.clamp(flat.pos // blk, 0, npages - 1).long()
    bids = torch.where(flat.live, page_tables[flat.row, page_idx],
                       torch.zeros_like(page_tables[0, :1]))
    # a spare slot's K/V may come from garbage (its attention reads a
    # padded query row) and lands in the null block, which K1's masked
    # tiles read at probability 0: zeros keep a NaN out of it
    live = flat.live[:, None, None]
    _write_pages(k_pool, v_pool, bids, (flat.pos % blk).long(),
                 torch.where(live, k[0], 0), torch.where(live, v[0], 0))
    qb = q.new_empty((BC + flat.idx.numel(), *q.shape[2:]))
    qb.index_copy_(0, flat.idx, q[0])
    o = pa.paged_prefill_attention(qb[:BC].view(B, flat.C, *q.shape[2:]),
                                   k_pool, v_pool, cache_lens, valids,
                                   page_tables, pairing=_pairing(cfg))
    return (flat.gather(o.reshape(BC, -1)) @ params["wo"])[None]


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
    if runs_kernels(x.device):
        o = da.decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                                pairing=_pairing(cfg))
    else:
        o = simple_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                             causal=False, kv_len=kv_len,
                             pairing=_pairing(cfg))
    return o.reshape(b, 1, -1) @ params["wo"]


# ------------------------------------------------------------------ MLA

def init_mla(cfg: ModelConfig, *, generator, device, dtype=torch.float32):
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "wq": _init((d, h * qk), **kw),
        # joint down-projection: [c_kv (rank) | k_rope (rope_dim)]
        "w_dkv": _init((d, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
        "kv_norm": torch.zeros((m.kv_lora_rank,), device=device,
                               dtype=dtype),
        # up-projections from the latent: per head [k_nope | v]
        "w_uk": _init((m.kv_lora_rank, h * m.qk_nope_head_dim), **kw),
        "w_uv": _init((m.kv_lora_rank, h * m.v_head_dim), **kw),
        "wo": _init((h * m.v_head_dim, d), **kw)}


def _mla_qkv(params, x, cfg: ModelConfig, positions):
    """x: (b, s, d) -> q_nope (b, s, h, nope), q_rope (b, s, h, rope), the
    normed latent c_kv (b, s, rank) and the shared k_rope (b, s, rope),
    both ropes rotated at ``positions``."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, qk)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    dkv = x @ params["w_dkv"]
    c_kv = rms_norm(dkv[..., : m.kv_lora_rank], params["kv_norm"],
                    cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:]
    cos, sin = rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(m: MLAConfig) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_full(params, x, cfg: ModelConfig, *, return_kv=False):
    """x: (b, s, d) -> (b, s, d) causal output, positions 0..s-1 (and the
    cache entries (c_kv, k_rope) when ``return_kv``). K/V are decompressed
    per head: q and k are [nope | rope] (the rope half of k shared by the
    heads), v is v_head_dim wide, so attention runs at d != dv."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = torch.arange(s, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, pos)
    k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, s, h, m.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    o = attention(q_full, k_full, v, causal=True, scale=_mla_scale(m))
    out = o.reshape(b, s, h * m.v_head_dim) @ params["wo"]
    return (out, (c_kv, k_rope)) if return_kv else out


def mla_decode(params, x, cache_ckv, cache_krope, cache_len,
               cfg: ModelConfig):
    """Absorbed decode: x (b, 1, d) at the scalar position ``cache_len``
    against the latent caches cache_ckv (b, S, rank) and cache_krope
    (b, S, rope), this token's entries written IN PLACE there; returns the
    (b, 1, d) output. W_uk is absorbed into q and W_uv applied after the
    latent output, so the cache stays rank + rope wide. A per-slot length
    vector is refused, where the reference fails on it
    (``jnp.full((1,), cache_len)``)."""
    if torch.is_tensor(cache_len) and cache_len.ndim:
        raise ValueError(f"mla_decode takes a scalar cache_len, not shape "
                         f"{tuple(cache_len.shape)}: the reference's MLA "
                         "decode has no per-slot lengths")
    m: MLAConfig = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    cache_len = int(cache_len)
    pos = torch.tensor([cache_len], device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, pos)
    cache_ckv[:, cache_len] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, cache_len] = k_rope[:, 0].to(cache_krope.dtype)
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), cache_ckv.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                          cache_krope.float())
    s = (s_lat + s_rope) * _mla_scale(m)
    kpos = torch.arange(cache_ckv.shape[1], device=x.device)
    s = s.masked_fill(kpos >= cache_len + 1, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", p.to(cache_ckv.dtype), cache_ckv)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    return o.reshape(b, 1, h * m.v_head_dim) @ params["wo"]
