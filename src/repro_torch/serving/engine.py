"""Continuous-batching dense slot engine: the port of
``repro.serving.engine``.

Slot-based: a fixed decode batch of ``max_slots`` sequences advances one
token per ``step()``; prefill fills an empty slot's rows of the batched
cache (iteration-level scheduling, Orca-style). Lanes in the middleware map
1:1 onto slots here. On the card a prefill runs the flash kernel (K3) and
a decode step the decode kernel (K4) in every layer; the cache is one
contiguous (L, max_slots, max_len, hkv, hd) tensor per K and V, updated in
place. ``extract_slot`` / ``restore_slot`` move one slot's cache as numpy
arrays in the reference's layout (bf16 as uint16 bits, an fp8 cache's
float8_e4m3fn as uint8 bits), which is what backs CLM hibernation at
engine level.

Compiled dispatch (``cuda_graphs``, the counterpart of the reference's
``jax.jit`` of ``decode_step`` and of its prefill): on the card the decode
step is one CUDA graph (``serving.graphs``), captured at its first call
over the engine's persistent tensors (the cache ``state``, ``_last_tok``,
``lens``, which are only ever written in place, never rebound) and
replayed at each later step. The prefill is one graph per prompt length,
as jit compiles one per length: the prompt prefills into a one-row
scratch state of its length, which the same graph then copies into the
cache at the staged slot index (the reference's ``dynamic_update_slice``
of its prefill state). The graphs share the engine's one memory pool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import bits, resolve_device
from repro_torch.models import build
from repro_torch.models.transformer import check_gqa_family
from repro_torch.serving import graphs
from repro_torch.weights import host_as, torch_to_numpy


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
                 max_len: int = 256, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        check_gqa_family(cfg)
        self.device = resolve_device(device)
        # None -> graphs of the decode step and the prefills on the card;
        # False is the eager step (``jax.disable_jit()``'s counterpart),
        # kept for same-call A/Bs and parity checks
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError("cuda_graphs=True needs a CUDA device, not "
                             f"{self.device}")
        self.cuda_graphs = bool(cuda_graphs)
        # the captured decode and prefills (None: the eager route)
        self.graphs = (graphs.StepGraphs(self.device) if self.cuda_graphs
                       else None)
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
            logits = self._dispatch(
                ("prefill", plen), self._prefill,
                {"toks": req.prompt[None].astype(np.int32),
                 "slot": np.array([slot], np.int32)})
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
        logits = self._dispatch("decode", self._decode)
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

    def _dispatch(self, key, fn, arrays: Optional[Dict] = None):
        """``fn`` over ``arrays`` (numpy; None: ``fn()``): on the eager
        route as fresh device tensors, else replayed from ``key``'s
        captured step (captured at its first call)."""
        if self.graphs is None:
            return fn(**{n: torch.from_numpy(a).to(self.device)
                         for n, a in (arrays or {}).items()})
        return self.graphs.run(key, fn, arrays)

    def _prefill(self, toks, slot):
        """One prompt (1, plen) into a fresh one-row state of its length,
        then that row into the cache at ``slot`` ((1,) int32 on the device)
        over positions [0, plen): the last position's (1, 1, vocab) f32
        logits."""
        plen = toks.shape[1]
        pre = self.model.init_decode_state(1, plen, device=self.device)
        logits = self.model.prefill(self.params, toks, state=pre)
        for name, c in self.state.items():
            # as bits: index_copy_ has no float8 kernel
            bits(c)[:, :, :plen].index_copy_(1, slot.long(),
                                             bits(pre[name]))
        return logits

    def _decode(self):
        """Every slot one token: (max_slots, 1, vocab) f32 logits; the
        cache is written in place."""
        return self.model.decode_step(self.params, self.state,
                                      self._last_tok, self.lens)

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

    def graph_stats(self) -> Dict:
        """``cuda_graphs``, and on the graph route the captured steps
        (the decode and one prefill per prompt length): graphs, first
        calls, replays, capture seconds and graph-pool bytes per key."""
        out = {"cuda_graphs": self.cuda_graphs}
        if self.graphs is not None:
            out.update(self.graphs.stats())
        return out

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
        """Write a payload of ``extract_slot``'s layout into ``slot``, read
        by the cache's dtype (``weights.host_as``: bits as bits)."""
        for name, c in self.state.items():
            bits(c)[:, slot] = bits(host_as(payload[name],
                                            c.dtype)).to(c.device)
        self.lens[slot] = length
