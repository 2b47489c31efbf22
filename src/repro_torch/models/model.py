"""``build(cfg)``: the model namespace the engines use, with ``cfg`` bound
(the port of ``repro.models.model.build``, for every architecture of the
registry). A member the reference lacks for a family raises
``NotImplementedError`` when called, naming why."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.weights import stack_layers


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (*, generator=None, seed=0, device="cuda") -> random params, prepared
    init_params: Callable
    # (params, tokens (b, s), **inputs) -> logits (b, s, V) f32 over the
    # text; inputs: patch_embeds= (VLM), frame_embeds= (encoder-decoder)
    forward: Callable
    # (batch, max_len, device="cuda") -> the decode state: K/V caches,
    # or conv/SSD states and rings
    init_decode_state: Callable
    # (params, tokens, *, state, **inputs) -> last logits (b, 1, V); fills
    # state
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
    # (master, batch) -> (total, {"ce", "moe_aux", "moe_z"}), 0-d f32
    # tensors; master: the float32 tree in the reference's layout
    loss: Callable
    # (*, generator=None, seed=0, device="cuda") -> random master params
    init_train_params: Callable


def _lacks(cfg: ModelConfig, member: str, why: str) -> Callable:
    """A member the reference does not have for this family."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): no "
                                  f"{member}; {why}")
    return refuse


def _init_train_params(family, cfg: ModelConfig, *, generator: Optional[
        torch.Generator] = None, seed: int = 0, device="cuda") -> Dict:
    """Random master params for training: the draws of the family
    module's ``init_params`` in ``cfg.param_dtype`` (float32), in the
    reference's layout (layers stacked on a leading axis)."""
    family._check_supported(cfg)
    dev = resolve_device(device)
    return stack_layers(family._raw_params(cfg, generator, seed, dev,
                                           torch_dtype(cfg.param_dtype)))


def build(cfg: ModelConfig) -> Model:
    paged = "the paged pools hold the GQA family's K/V alone"
    if cfg.is_encoder_decoder:
        encdec._check_supported(cfg)
        return Model(
            cfg=cfg,
            loss=functools.partial(encdec.loss, cfg=cfg),
            init_train_params=functools.partial(_init_train_params, encdec,
                                                cfg),
            init_params=functools.partial(encdec.init_params, cfg),
            forward=functools.partial(encdec.forward, cfg=cfg),
            init_decode_state=functools.partial(encdec.init_decode_state,
                                                cfg),
            prefill=_lacks(cfg, "prefill", "the reference's encoder-decoder "
                           "has none; run encdec.init_cross_cache, then "
                           "decode_step"),
            decode_step=functools.partial(encdec.decode_step, cfg=cfg),
            decode_step_paged=_lacks(cfg, "decode_step_paged", paged),
            prefill_chunk_paged=_lacks(cfg, "prefill_chunk_paged", paged),
            mixed_step_paged=_lacks(cfg, "mixed_step_paged", paged))
    if cfg.family == "hybrid":
        hybrid._check_supported(cfg)
        return Model(
            cfg=cfg,
            loss=functools.partial(hybrid.loss, cfg=cfg),
            init_train_params=functools.partial(_init_train_params, hybrid,
                                                cfg),
            init_params=functools.partial(hybrid.init_params, cfg),
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

    train = dict(loss=bind(transformer.loss),
                 init_train_params=functools.partial(
                     _init_train_params, transformer, cfg))

    if cfg.family == "ssm" or cfg.mla is not None:
        paged = ("an SSM keeps no K/V for the paged pools"
                 if cfg.family == "ssm" else
                 "the reference's paged pools assert mla is None")
        return Model(
            cfg=cfg, **train,
            init_params=functools.partial(transformer.init_params, cfg),
            forward=bind(transformer.forward),
            init_decode_state=functools.partial(transformer.init_decode_state,
                                                cfg),
            prefill=bind(transformer.prefill),
            decode_step=bind(transformer.decode_step),
            decode_step_paged=_lacks(cfg, "decode_step_paged", paged),
            prefill_chunk_paged=_lacks(cfg, "prefill_chunk_paged", paged),
            mixed_step_paged=_lacks(cfg, "mixed_step_paged", paged))
    return Model(
        cfg=cfg, **train,
        init_params=functools.partial(transformer.init_params, cfg),
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


def abstract_params(cfg: ModelConfig) -> Dict:
    """The master params on ``meta`` (shapes and dtypes, no storage): the
    reference's stacked layout in ``cfg.param_dtype``, which the training
    rules walk (the dry-run's)."""
    return build(cfg).init_train_params(device="meta")


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int
                          ) -> Dict:
    """The decode state of ``batch`` rows of ``max_len`` positions on
    ``meta``."""
    return build(cfg).init_decode_state(batch, max_len, device="meta")
