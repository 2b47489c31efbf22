"""Whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``, run eagerly. The conv audio frontend is a stub:
``frame_embeds`` (b, enc_len, d) arrive precomputed.

Learned absolute positions (``rotary_pct = 0``: no RoPE), a bidirectional
encoder, a causal decoder with cross-attention to the encoder's output.
The decoder's position table holds ``MAX_DEC_POS`` positions.

  * ``encode`` — the encoder (K3, not causal, in every layer on the card);
  * ``forward`` — teacher-forced decoder logits over the text (K3 causal
    for self-attention, K3 not causal for cross-attention at sq = s_text);
  * ``init_decode_state`` / ``init_cross_cache`` / ``decode_step`` — the
    session's caches: self-attention K/V written one token a step (K4) and
    each layer's cross K/V precomputed once from the encoder (K3, not
    causal, at sq = 1).

The reference has no encoder-decoder prefill and no paged members, and its
engines refuse the family. Params are the prepared dict of
``repro_torch.weights`` (``enc_layers`` and ``layers`` as lists; ``lm_head``
replaced by the f32 ``unembed``). Caches are updated in place. ``loss``
takes the master tree (``Model.init_train_params``: float32, both stacks
stacked) and a batch with ``frame_embeds``, and returns (ce, {"ce",
"moe_aux", "moe_z"}), the last two zero; with ``cfg.remat`` each encoder
and decoder layer runs under ``torch.utils.checkpoint`` and
``cfg.remat_policy`` (``transformer.remat_wrap``), where the reference
remats them (the decoder layer computes its cross K/V inside, as there).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (FP8, resolve_device, seeded_generator,
                                torch_dtype)
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (_init, apply_mlp, cross_entropy_loss,
                                       init_mlp, rms_norm)
from repro_torch.models.transformer import (_unembed, refuse_fp8,
                                            remat_wrap)
from repro_torch.weights import forward_params, prepare_params

MAX_DEC_POS = 32768


def _check_supported(cfg: ModelConfig):
    if not cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: models.encdec serves the "
                                  "encoder-decoder family alone")


def _enc_layer(cfg: ModelConfig, kw: dict) -> Dict:
    zeros = dict(device=kw["device"], dtype=kw["dtype"])
    return {"attn_norm": torch.zeros((cfg.d_model,), **zeros),
            "attn": attn_mod.init_gqa(cfg, **kw),
            "mlp_norm": torch.zeros((cfg.d_model,), **zeros),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act, **kw)}


def _dec_layer(cfg: ModelConfig, kw: dict) -> Dict:
    p = _enc_layer(cfg, kw)
    p["cross_norm"] = torch.zeros((cfg.d_model,), device=kw["device"],
                                  dtype=kw["dtype"])
    p["cross"] = attn_mod.init_gqa(cfg, **kw)
    return p


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, seed: int = 0, device="cuda") -> Dict:
    """Random params drawn on ``device`` with a seeded torch generator (the
    reference's init distribution, torch's random numbers), prepared as
    ``weights.prepare_params`` does."""
    _check_supported(cfg)
    dev = resolve_device(device)
    raw = _raw_params(cfg, generator, seed, dev,
                      torch_dtype(cfg.compute_dtype))
    return prepare_params(raw, cfg, dev)


def _raw_params(cfg: ModelConfig, generator, seed: int, dev, dtype) -> Dict:
    """Every leaf drawn in ``dtype``, both stacks as lists."""
    if generator is None:
        generator = seeded_generator(dev, seed)
    kw = dict(generator=generator, device=dev, dtype=dtype)
    d = cfg.d_model
    return {"embed": _init((cfg.vocab_size, d), scale=0.02, **kw),
            "dec_pos": _init((MAX_DEC_POS, d), scale=0.02, **kw),
            "enc_pos": _init((cfg.enc_len, d), scale=0.02, **kw),
            "enc_layers": [_enc_layer(cfg, kw)
                           for _ in range(cfg.n_enc_layers)],
            "enc_final_norm": torch.zeros((d,), device=dev, dtype=dtype),
            "layers": [_dec_layer(cfg, kw) for _ in range(cfg.n_layers)],
            "final_norm": torch.zeros((d,), device=dev, dtype=dtype),
            "lm_head": _init((d, cfg.vocab_size), **kw)}


def _mlp(lp, x, cfg: ModelConfig):
    return apply_mlp(lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps),
                     cfg.act)


def encode(params, frame_embeds, cfg: ModelConfig):
    """frame_embeds (b, s_enc, d) -> the encoder's normed output, same
    shape, in the compute dtype."""
    x = frame_embeds.to(torch_dtype(cfg.compute_dtype))
    x = x + params["enc_pos"][: x.shape[1]].to(x.dtype)
    layer = remat_wrap(lambda lp, h: _enc_layer_full(lp, h, cfg), cfg)
    for lp in params["enc_layers"]:
        x = layer(lp, x)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _enc_layer_full(lp, x, cfg: ModelConfig):
    x = x + attn_mod.gqa_full(
        lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
        causal=False)
    return x + _mlp(lp, x, cfg)


def _cross_kv(cp, enc, cfg: ModelConfig):
    b, s, _ = enc.shape
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return ((enc @ cp["wk"]).reshape(b, s, hkv, hd),
            (enc @ cp["wv"]).reshape(b, s, hkv, hd))


def _cross(lp, x, kv, cfg: ModelConfig):
    return attn_mod.gqa_cross(
        lp["cross"], rms_norm(x, lp["cross_norm"], cfg.norm_eps), kv, cfg)


def forward(params, tokens, cfg: ModelConfig, *, frame_embeds):
    """tokens (b, s) int, frame_embeds (b, s_enc, d) -> logits (b, s, V)
    float32 over the text."""
    enc = encode(params, frame_embeds, cfg)
    s = tokens.shape[1]
    x = params["embed"][tokens.long()] + params["dec_pos"][:s]
    layer = remat_wrap(lambda lp, h, e: _dec_layer_full(lp, h, e, cfg), cfg)
    for lp in params["layers"]:
        x = layer(lp, x, enc)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def _dec_layer_full(lp, x, enc, cfg: ModelConfig):
    x = x + attn_mod.gqa_full(
        lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
        causal=True)
    x = x + _cross(lp, x, _cross_kv(lp["cross"], enc, cfg), cfg)
    return x + _mlp(lp, x, cfg)


def loss(params, batch: Dict, cfg: ModelConfig):
    """params: the master tree; batch: ``tokens``, ``labels`` (b, s) and
    ``frame_embeds`` (b, enc_len, d). Returns (ce, {"ce", "moe_aux": 0,
    "moe_z": 0})."""
    logits = forward(forward_params(params, cfg), batch["tokens"], cfg,
                     frame_embeds=batch["frame_embeds"])
    ce = cross_entropy_loss(logits, batch["labels"])
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"moe_aux": zero, "moe_z": zero, "ce": ce}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed caches in the KV cache dtype: self-attention ``k``/``v``
    (L, batch, max_len, hkv, hd) and cross-attention ``cross_k``/
    ``cross_v`` (L, batch, enc_len, hkv, hd)."""
    _check_supported(cfg)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    if ct == FP8:
        raise ValueError(refuse_fp8(cfg, "the encoder-decoder's caches"))
    dev = resolve_device(device)
    h, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    return {name: torch.zeros((L, batch, S, h, hd), dtype=ct, device=dev)
            for name, S in (("k", max_len), ("v", max_len),
                            ("cross_k", cfg.enc_len),
                            ("cross_v", cfg.enc_len))}


def init_cross_cache(params, frame_embeds, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the encoder and precompute every decoder layer's cross K/V (the
    session's start): (cross_k, cross_v), each (L, b, s_enc, hkv, hd), for
    the decode state's ``cross_k`` / ``cross_v``."""
    enc = encode(params, frame_embeds, cfg)
    kvs = [_cross_kv(lp["cross"], enc, cfg) for lp in params["layers"]]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def decode_step(params, state: Dict, token, cache_len, cfg: ModelConfig):
    """token (b, 1) at the scalar position ``cache_len`` -> logits
    (b, 1, V) float32; the self-attention caches of ``state`` are written
    in place, its cross K/V read."""
    if torch.is_tensor(cache_len) and cache_len.ndim:
        raise ValueError("the encoder-decoder decodes at a scalar cache_len, "
                         "as the reference does")
    cache_len = int(cache_len)
    x = params["embed"][token.long()] \
        + params["dec_pos"][cache_len:cache_len + 1]
    for li, lp in enumerate(params["layers"]):
        x = x + attn_mod.gqa_decode(
            lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
            state["k"][li], state["v"][li], cache_len, cfg)
        x = x + _cross(lp, x, (state["cross_k"][li], state["cross_v"][li]),
                       cfg)
        x = x + _mlp(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))
