"""Zamba2-style hybrid: a Mamba-2 backbone and ONE weight-shared attention
block, the port of ``repro.models.hybrid``, run eagerly.

Layer layout for n_layers = G * attn_every + tail:
  G times: [shared attention block] -> attn_every Mamba-2 layers,
  then ``tail`` trailing Mamba-2 layers.
The shared block's weights serve every application, but each application
keeps its own ring-buffer KV cache (its activations differ).

Entry points: ``forward`` (K3 in each application of the shared block, K5
in each Mamba-2 layer), ``init_decode_state`` and ``decode_step`` (K4
through each ring). The reference has no hybrid prefill: a hybrid is served
through ``decode_step`` from position 0. Params are the prepared dict of
``repro_torch.weights``: ``groups`` a list of G lists of attn_every layer
dicts, ``tail`` a list, ``shared`` one dict. Decode state is updated in
place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import _init, apply_mlp, init_mlp, rms_norm
from repro_torch.models.transformer import (_embed, _mamba_decode,
                                            _mamba_full, _unembed)
from repro_torch.weights import prepare_params


def _check_supported(cfg: ModelConfig):
    if cfg.family != "hybrid" or not cfg.attn_every or cfg.ssm is None:
        raise NotImplementedError(
            f"{cfg.name}: models.hybrid serves the Mamba-2 + shared "
            "attention hybrid (family 'hybrid', attn_every > 0)")


def _layout(cfg: ModelConfig):
    g = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers - g * cfg.attn_every
    return g, cfg.attn_every, tail


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
    g, e, tail = _layout(cfg)

    def mamba_one():
        return {"norm": torch.zeros((cfg.d_model,), **zeros),
                "mamba": ssd_mod.init_mamba(cfg, **kw)}

    raw = {
        "embed": _init((cfg.vocab_size, cfg.d_model), scale=0.02, **kw),
        "final_norm": torch.zeros((cfg.d_model,), **zeros),
        "lm_head": _init((cfg.d_model, cfg.vocab_size), **kw),
        "shared": {"attn_norm": torch.zeros((cfg.d_model,), **zeros),
                   "attn": attn_mod.init_gqa(cfg, **kw),
                   "mlp_norm": torch.zeros((cfg.d_model,), **zeros),
                   "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act, **kw)},
        "groups": [[mamba_one() for _ in range(e)] for _ in range(g)],
    }
    if tail:
        raw["tail"] = [mamba_one() for _ in range(tail)]
    return prepare_params(raw, cfg, dev)


def _shared_block_full(sp, x, cfg: ModelConfig, window: int = 0):
    x = x + attn_mod.gqa_full(sp["attn"],
                              rms_norm(x, sp["attn_norm"], cfg.norm_eps), cfg,
                              window=window)
    return x + apply_mlp(sp["mlp"], rms_norm(x, sp["mlp_norm"], cfg.norm_eps),
                         cfg.act)


def forward(params, tokens, cfg: ModelConfig):
    """tokens: (b, s) int -> logits (b, s, V) float32, every position; s
    at most the chunk or a multiple of it."""
    x = _embed(params, tokens, cfg)
    # full attention within the sequence: the window binds only beyond it
    win = 0 if x.shape[1] <= (cfg.attn_window or 1 << 62) \
        else cfg.attn_window
    for gp in params["groups"]:
        x = _shared_block_full(params["shared"], x, cfg, window=win)
        for lp in gp:
            x, _ = _mamba_full(lp, x, cfg)
    for lp in params.get("tail", []):
        x, _ = _mamba_full(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed decode state: ``attn_k``/``attn_v`` (G, batch, W, hkv, hd),
    one ring of W = min(max_len, attn_window) slots (max_len without a
    window) per application of the shared block; ``conv``
    (G, E, batch, K-1, conv_dim) and ``ssm`` (G, E, batch, g, h/g, n, p)
    float32 per Mamba-2 layer of the groups, ``tail_conv``/``tail_ssm``
    (T, ...) for the tail's."""
    _check_supported(cfg)
    dev = resolve_device(device)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    g, e, tail = _layout(cfg)
    m, _, h, conv_dim = ssd_mod._dims(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    w = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    conv = (batch, m.conv_kernel - 1, conv_dim)
    ssm = (batch, m.n_groups, h // m.n_groups, m.d_state, m.head_dim)
    f32 = torch.float32
    st = {"attn_k": torch.zeros((g, batch, w, hkv, hd), dtype=ct, device=dev),
          "attn_v": torch.zeros((g, batch, w, hkv, hd), dtype=ct, device=dev),
          "conv": torch.zeros((g, e, *conv), dtype=ct, device=dev),
          "ssm": torch.zeros((g, e, *ssm), dtype=f32, device=dev)}
    if tail:
        st["tail_conv"] = torch.zeros((tail, *conv), dtype=ct, device=dev)
        st["tail_ssm"] = torch.zeros((tail, *ssm), dtype=f32, device=dev)
    return st


def decode_step(params, state: Dict, token, cache_len: int,
                cfg: ModelConfig):
    """token (b, 1) at position ``cache_len`` (an int: every row at one
    depth) -> logits (b, 1, V) float32; ``state`` is updated in place."""
    x = _embed(params, token, cfg)
    sp = params["shared"]
    for gi, gp in enumerate(params["groups"]):
        x = x + attn_mod.gqa_decode_ring(
            sp["attn"], rms_norm(x, sp["attn_norm"], cfg.norm_eps),
            state["attn_k"][gi], state["attn_v"][gi], cache_len, cfg)
        x = x + apply_mlp(sp["mlp"], rms_norm(x, sp["mlp_norm"],
                                              cfg.norm_eps), cfg.act)
        for ei, lp in enumerate(gp):
            x = _mamba_decode(lp, x, state["conv"][gi, ei],
                              state["ssm"][gi, ei], cfg)
    for ti, lp in enumerate(params.get("tail", [])):
        x = _mamba_decode(lp, x, state["tail_conv"][ti],
                          state["tail_ssm"][ti], cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))
