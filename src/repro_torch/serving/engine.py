"""Continuous-batching dense slot engine: the port of
``repro.serving.engine``.

Slot-based: a fixed decode batch of ``max_slots`` sequences advances one
token per ``step()``; prefill fills an empty slot's rows of the batched
cache (iteration-level scheduling, Orca-style). Lanes in the middleware map
1:1 onto slots here. On the card a prefill runs the flash kernel (K3) and
a decode step the decode kernel (K4) in every layer; the cache is one
contiguous (L, max_slots, max_len, hkv, hd) tensor per K and V, updated in
place. ``extract_slot`` / ``restore_slot`` move one slot's cache as numpy
arrays in the reference's layout (bf16 as uint16 bits), which is what
backs CLM hibernation at engine level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.weights import numpy_to_torch, torch_to_numpy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class InferenceEngine:
    """Greedy-decode engine for the decoder-only GQA family (the engine the
    serve examples use)."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_len: int = 256, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build(cfg)
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.state = self.model.init_decode_state(max_slots, max_len,
                                                  device=self.device)
        self.lens = torch.zeros((max_slots,), dtype=torch.int32,
                                device=self.device)
        self.active: Dict[int, Request] = {}
        self.free_slots = list(range(max_slots))
        self._next_rid = 0
        self._queue: List[Request] = []
        self._last_tok = torch.zeros((max_slots, 1), dtype=torch.int32,
                                     device=self.device)
        # dispatch accounting (same contract as the paged engine): model
        # calls vs step()s that ran any — benchmarks report the ratio
        self.jit_dispatches = 0
        self.steps_dispatched = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt, np.int32),
                                   max_new_tokens=max_new_tokens))
        return rid

    def _admit(self):
        while self._queue and self.free_slots:
            req = self._queue.pop(0)
            slot = self.free_slots.pop(0)
            req.slot = slot
            plen = len(req.prompt)
            # prefill writes its K/V straight into this slot's cache rows
            view = {name: c[:, slot:slot + 1]
                    for name, c in self.state.items()}
            logits = self.model.prefill(
                self.params, torch.from_numpy(req.prompt[None]).to(
                    self.device), state=view)
            self.jit_dispatches += 1
            self.lens[slot] = plen
            tok = int(torch.argmax(logits[0, -1]))
            req.out_tokens.append(tok)
            self._last_tok[slot, 0] = tok
            self.active[req.rid] = req

    # ------------------------------------------------------------ step
    def step(self) -> List[Request]:
        """Advance every active slot one token; returns finished requests."""
        self._admit()
        if not self.active:
            return []
        logits = self.model.decode_step(self.params, self.state,
                                        self._last_tok, self.lens)
        self.jit_dispatches += 1
        self.steps_dispatched += 1
        slots = torch.tensor([r.slot for r in self.active.values()],
                             dtype=torch.long, device=self.device)
        self.lens[slots] += 1
        toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        lens = self.lens.cpu().numpy()
        finished = []
        for rid, req in list(self.active.items()):
            tok = int(toks[req.slot])
            req.out_tokens.append(tok)
            self._last_tok[req.slot, 0] = tok
            if (len(req.out_tokens) >= req.max_new_tokens
                    or int(lens[req.slot]) >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.free_slots.append(req.slot)
                del self.active[rid]
        return finished

    def run_to_completion(self, max_steps: int = 512) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            done += self.step()
            if not self.active and not self._queue:
                break
        return done

    @property
    def jit_dispatches_per_step(self) -> float:
        """Model calls per work-doing iteration (prefills land in the
        admitting step, so a step admitting k prompts costs 1 + k)."""
        return self.jit_dispatches / max(self.steps_dispatched, 1)

    def sync(self):
        """Block until queued state updates have landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ hibernation
    def extract_slot(self, slot: int):
        """Session state slice for one slot (engine-level hibernation):
        ({"k", "v"} numpy (L, max_len, hkv, hd), length)."""
        return ({name: torch_to_numpy(c[:, slot])
                 for name, c in self.state.items()},
                int(self.lens[slot]))

    def restore_slot(self, slot: int, payload, length: int):
        for name, c in self.state.items():
            c[:, slot] = numpy_to_torch(payload[name]).to(c.device, c.dtype)
        self.lens[slot] = length
