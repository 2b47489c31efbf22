"""Synthetic-token data stream: deterministic and seekable (step -> batch),
so a resumed run replays the exact stream. The reference's stream
(``repro.training.data``) to the token: the same numpy generator, seeded
``(seed << 20) ^ step``, drawn in the same order; batches are torch tensors
on ``device``."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


class SyntheticLM:
    """Token stream with enough structure (every even position repeats the
    token before it, plus one) that the loss falls during training."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``tokens``/``labels`` (batch, seq) int32 (a VLM's text shortened
        by its image tokens, with ``patch_embeds`` (batch, n_image_tokens,
        d_model) float32); an encoder-decoder's ``frame_embeds`` (batch,
        enc_len, d_model) float32."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        v = self.cfg.vocab_size
        base = rng.integers(0, v, size=(self.batch, self.seq + 1),
                            dtype=np.int32)
        base[:, 2::2] = (base[:, 1:-1:2] + 1) % v
        out = {"tokens": base[:, :-1], "labels": base[:, 1:]}
        if self.cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_image_tokens, self.cfg.d_model),
                dtype=np.float32)
            text = self.seq - self.cfg.n_image_tokens
            out["tokens"] = out["tokens"][:, :text]
            out["labels"] = out["labels"][:, :text]
        if self.cfg.is_encoder_decoder:
            out["frame_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.enc_len, self.cfg.d_model),
                dtype=np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
