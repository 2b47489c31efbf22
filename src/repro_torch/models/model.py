"""``build(cfg)``: the model namespace the engines use, with ``cfg`` bound
(the port of ``repro.models.model.build`` for the dense GQA, SSM and
hybrid families)."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (params, tokens (b, s)) -> logits (b, s, V) f32
    forward: Callable
    # (batch, max_len, device="cuda") -> the decode state: K/V caches,
    # or conv/SSD states and rings
    init_decode_state: Callable
    # (params, tokens, *, state) -> last logits (b, 1, V); fills state
    prefill: Callable
    # (params, state, token (b, 1), cache_len int | (b,)) -> (b, 1, V)
    decode_step: Callable
    # (params, pools, token (b, 1), cache_len (b,), page_tables) -> (b, 1, V)
    decode_step_paged: Callable
    # (params, pools, tokens (1, C), cache_len, valid, page_table) -> (1, C, V)
    prefill_chunk_paged: Callable
    # (params, pools, toks, cache_lens, valids, page_tables, poison_mask)
    # -> (B,) int32 next ids; pools are written in place
    mixed_step_paged: Callable


def _lacks(cfg: ModelConfig, member: str, why: str) -> Callable:
    """A member the reference does not have for this family."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): no "
                                  f"{member}; {why}")
    return refuse


def build(cfg: ModelConfig) -> Model:
    """Raises ``NotImplementedError`` for a family the port does not serve
    yet (MoE, MLA, enc-dec, VLM)."""
    if cfg.family == "hybrid":
        hybrid._check_supported(cfg)
        paged = "the paged pools hold the GQA family's K/V alone"
        return Model(
            cfg=cfg,
            forward=functools.partial(hybrid.forward, cfg=cfg),
            init_decode_state=functools.partial(hybrid.init_decode_state,
                                                cfg),
            prefill=_lacks(cfg, "prefill", "the reference's hybrid has "
                           "none; feed the prompt through decode_step"),
            decode_step=functools.partial(hybrid.decode_step, cfg=cfg),
            decode_step_paged=_lacks(cfg, "decode_step_paged", paged),
            prefill_chunk_paged=_lacks(cfg, "prefill_chunk_paged", paged),
            mixed_step_paged=_lacks(cfg, "mixed_step_paged", paged))
    transformer._check_supported(cfg)

    def bind(fn):
        return functools.partial(fn, cfg=cfg)

    if cfg.family == "ssm":
        paged = "an SSM keeps no K/V for the paged pools"
        return Model(
            cfg=cfg,
            forward=bind(transformer.forward),
            init_decode_state=functools.partial(transformer.init_decode_state,
                                                cfg),
            prefill=bind(transformer.prefill),
            decode_step=bind(transformer.decode_step),
            decode_step_paged=_lacks(cfg, "decode_step_paged", paged),
            prefill_chunk_paged=_lacks(cfg, "prefill_chunk_paged", paged),
            mixed_step_paged=_lacks(cfg, "mixed_step_paged", paged))
    return Model(
        cfg=cfg,
        forward=bind(transformer.forward),
        init_decode_state=functools.partial(transformer.init_decode_state,
                                            cfg),
        prefill=bind(transformer.prefill),
        decode_step=bind(transformer.decode_step),
        decode_step_paged=bind(transformer.decode_step_paged),
        prefill_chunk_paged=bind(transformer.prefill_chunk_paged),
        mixed_step_paged=lambda params, pools, toks, lens, valids, tables,
        poison=None: transformer.mixed_step_paged(
            params, pools, toks, lens, valids, tables, cfg, poison),
    )
