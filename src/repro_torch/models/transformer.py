"""Decoder-only LM, dense GQA family: the port of
``repro.models.transformer``, run eagerly.

  * ``forward`` — logits over a full sequence (teacher forcing);
  * ``init_decode_state`` / ``prefill`` / ``decode_step`` — the contiguous
    KV cache of the lockstep decode and the dense slot engine;
  * ``init_paged_pools`` / ``decode_step_paged`` / ``prefill_chunk_paged``
    — the legacy paged loop;
  * ``mixed_step_paged`` — the megastep: one call advances the whole mixed
    batch one engine iteration.

Params are the prepared dict of ``repro_torch.weights`` (compute dtype,
layers as a list). Caches and pools are device tensors updated in place,
where the reference returns new donated buffers; the functions return only
their logits or ids.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import _init, apply_mlp, init_mlp, rms_norm
from repro_torch.weights import prepare_params


def _check_supported(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.moe is not None or cfg.mla is not None \
            or cfg.first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense GQA family only; MoE, "
            "MLA, SSM and VLM stacks come in a later slice")


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, seed: int = 0, device="cuda") -> Dict:
    """Random params drawn on ``device`` with a seeded torch generator (the
    reference's init distribution, torch's random numbers), prepared as
    ``weights.prepare_params`` does."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    ct = torch_dtype(cfg.compute_dtype)
    kw = dict(generator=generator, device=dev, dtype=ct)
    zeros = dict(device=dev, dtype=ct)
    raw = {"embed": _init((cfg.vocab_size, cfg.d_model), scale=0.02, **kw),
           "final_norm": torch.zeros((cfg.d_model,), **zeros),
           "layers": [{"attn_norm": torch.zeros((cfg.d_model,), **zeros),
                       "mlp_norm": torch.zeros((cfg.d_model,), **zeros),
                       "attn": attn_mod.init_gqa(cfg, **kw),
                       "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act, **kw)}
                      for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        raw["lm_head"] = _init((cfg.d_model, cfg.vocab_size), **kw)
    return prepare_params(raw, cfg, dev)


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """(L, num_blocks, blk, hkv, hd) K and V pools. Zero-filled, never
    ``torch.empty``: masked positions still enter p.V with p == 0, and a
    NaN in the null block or a stale slot would turn that into NaN."""
    _check_supported(cfg)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=ct, device=dev),
            "v": torch.zeros(shape, dtype=ct, device=dev)}


def _embed(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        # the scale is rounded to the compute dtype first, as the reference
        # multiplies by jnp.asarray(d ** 0.5, x.dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _unembed(params, h):
    return h.float() @ params["unembed"]


def _mlp(lp, x, cfg: ModelConfig):
    return apply_mlp(lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps),
                     cfg.act)


# ------------------------------------------------------------ full forward

def _layer_full(x, lp, cfg: ModelConfig, return_kv=False):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, kv = (attn_mod.gqa_full(lp["attn"], h, cfg, return_kv=True)
             if return_kv else (attn_mod.gqa_full(lp["attn"], h, cfg), None))
    x = x + a
    return x + _mlp(lp, x, cfg), kv


def forward(params, tokens, cfg: ModelConfig):
    """tokens: (b, s) int -> logits (b, s, V) float32, every position."""
    x = _embed(params, tokens, cfg)
    for lp in params["layers"]:
        x, _ = _layer_full(x, lp, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed contiguous KV cache: ``k``/``v`` of shape
    (L, batch, max_len, hkv, hd) in the KV cache dtype."""
    _check_supported(cfg)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=ct, device=dev),
            "v": torch.zeros(shape, dtype=ct, device=dev)}


def _fill(cache, new):
    """Write prefill K/V (b, s, hkv, hd) into positions 0.. of one layer's
    cache, in place."""
    cache[:, :new.shape[1]] = new.to(cache.dtype)


def prefill(params, tokens, cfg: ModelConfig, *, state: Dict):
    """Full-sequence prefill. tokens: (b, s) -> the last position's logits
    (b, 1, V) float32; each layer's K/V is written into positions [0, s)
    of ``state`` (the dict of ``init_decode_state``, or views of one), in
    place."""
    x = _embed(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        x, (k, v) = _layer_full(x, lp, cfg, return_kv=True)
        _fill(state["k"][li], k)
        _fill(state["v"][li], v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x[:, -1:])


def _layer_decode(lp, x, k_cache, v_cache, cache_len, cfg: ModelConfig):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + attn_mod.gqa_decode(lp["attn"], h, k_cache, v_cache, cache_len,
                                cfg)
    return x + _mlp(lp, x, cfg)


def decode_step(params, state: Dict, token, cache_len, cfg: ModelConfig):
    """token (b, 1) -> logits (b, 1, V) float32; ``state`` is updated in
    place. cache_len: an int (every row at one depth: the lockstep decode)
    or a (b,) int32 tensor (per-slot depths)."""
    x = _embed(params, token, cfg)
    for li, lp in enumerate(params["layers"]):
        x = _layer_decode(lp, x, state["k"][li], state["v"][li], cache_len,
                          cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def decode_step_paged(params, pools: Dict, token, cache_len, page_tables,
                      cfg: ModelConfig):
    """Paged analogue of ``decode_step``: token (b, 1) int32, cache_len (b,)
    int32 lengths before this token, page_tables (b, npages) int32; pools
    written in place. Returns logits (b, 1, V) float32."""
    x = _embed(params, token, cfg)
    for li, lp in enumerate(params["layers"]):
        hh = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_decode_paged(
            lp["attn"], hh, pools["k"][li], pools["v"][li], page_tables,
            cache_len, cfg)
        x = x + _mlp(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def prefill_chunk_paged(params, pools: Dict, tokens, cache_len: int,
                        valid: int, page_table, cfg: ModelConfig):
    """Chunked prefill of one sequence over the paged pools: tokens (1, C)
    int32, null-padded past ``valid``; cache_len: the tokens resident
    before the chunk; page_table (npages,) int32. The chunk's K/V is
    written into the sequence's pages in place. Returns logits (1, C, V)
    float32 (the caller reads position ``valid - 1``)."""
    x = _embed(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        hh = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_prefill_chunk_paged(
            lp["attn"], hh, pools["k"][li], pools["v"][li], page_table,
            cache_len, valid, cfg)
        x = x + _mlp(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def mixed_step_paged(params, pools: Dict, tokens, cache_lens, valids,
                     page_tables, cfg: ModelConfig, poison_mask=None):
    """tokens: (B, C) int32, row b carrying ``valids[b]`` real tokens
    (decode rows: the last sampled token at column 0); cache_lens/valids:
    (B,) int32; page_tables: (B, npages) int32, null-padded; pools: the
    (L, ...) K/V tensors, written in place. Greedy sampling is part of the
    step: only each row's last valid column is unembedded and argmaxed.
    Returns (B,) int32 next ids; a row whose logits are not finite (or is
    set in ``poison_mask``) returns -1."""
    x = _embed(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        hh = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_mixed_step_paged(
            lp["attn"], hh, pools["k"][li], pools["v"][li], page_tables,
            cache_lens, valids, cfg)
        x = x + _mlp(lp, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    rows = torch.arange(x.shape[0], device=x.device)
    last = torch.clamp(valids.long() - 1, 0, x.shape[1] - 1)
    logits = _unembed(params, x[rows, last])          # (B, V) f32
    if poison_mask is not None:
        # poison lands after the K/V writes, so only this row's sampled
        # token is affected
        logits = torch.where(poison_mask[:, None],
                             torch.full_like(logits, float("nan")), logits)
    row_ok = torch.isfinite(logits).all(dim=-1)
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(row_ok, ids, torch.full_like(ids, -1))
