"""Architecture registry: ``--arch <id>`` lookup and input stand-ins (the
port of ``repro.configs.registry``).

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device (shape
and dtype, no storage) for every model input of one cell. Modality
frontends (whisper's audio conv, llava's vision tower) are stubs: their
precomputed embeddings appear here as inputs, in the compute dtype.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      SHAPES_BY_NAME, shape_applicable)
from repro_torch.device import torch_dtype

_ARCH_MODULES = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; "
                       f"known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str,
                                                                torch.Tensor]:
    """Meta-tensor stand-ins for one (arch x shape) cell.

    train:   {tokens, labels[, frame_embeds | patch_embeds]}
    prefill: {tokens[, frame_embeds | patch_embeds]}
    decode:  {token, cache_len}: the token streams only; the session
             state's specs come from the serving layer.
    """
    b, s = shape.global_batch, shape.seq_len
    ct = torch_dtype(cfg.compute_dtype)
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        text = s
        if cfg.family == "vlm":
            text = s - cfg.n_image_tokens
            specs["patch_embeds"] = _spec((b, cfg.n_image_tokens,
                                           cfg.d_model), ct)
        if cfg.is_encoder_decoder:
            specs["frame_embeds"] = _spec((b, cfg.enc_len, cfg.d_model), ct)
        specs["tokens"] = _spec((b, text), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _spec((b, text), torch.int32)
    else:  # decode: one new token against a seq_len-deep session state
        specs["token"] = _spec((b, 1), torch.int32)
        specs["cache_len"] = _spec((), torch.int32)
    return specs


def iter_cells():
    """Yield every (arch, shape, applicable, why) assignment cell."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            yield arch, shape, ok, why


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "input_specs",
           "iter_cells", "SHAPES", "SHAPES_BY_NAME"]
