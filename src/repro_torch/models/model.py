"""``build(cfg)``: the model namespace the engines use, with ``cfg`` bound
(the port of ``repro.models.model.build`` for the dense GQA family)."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (params, tokens (b, s)) -> logits (b, s, V) f32
    forward: Callable
    # (batch, max_len, device="cuda") -> {"k", "v"} (L, batch, max_len, ...)
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


def build(cfg: ModelConfig) -> Model:
    """Raises ``NotImplementedError`` for a family the port does not serve
    yet (MoE, MLA, SSM, VLM)."""
    transformer._check_supported(cfg)

    def bind(fn):
        return functools.partial(fn, cfg=cfg)

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
