"""The system under test, built as a deployment builds it, and the thin
client-side backend that times it.

One stack: ``AgentRM`` (the fused MLFQ dispatcher) over a
``PagedEngineBackend`` over a ``PagedInferenceEngine`` on the megastep,
with a token budget and every bucket width captured as a CUDA graph by
``compile_buckets`` before any traffic. The pool holds the pages the
configuration file states: as many as its cells' traffic can fill.

``TimedBackend`` is the port's ``PagedEngineBackend``, subclassed so that
AgentRM still picks its fused dispatcher by type; it only calls through,
and on the benchmark's clock stamps each token a step produced, each
step's span, its bucket width and the rows it carried, each turn's
``begin_turn`` call, and the most pages the pool ever held.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import AgentRM, AgentRMConfig
from repro_torch.serving import PagedEngineBackend, PagedInferenceEngine
from repro_torch.weights import prepare_params

@dataclasses.dataclass
class TurnLog:
    """What the backend saw of one turn."""
    agent_id: str
    prompt: str
    t_begin: Optional[float] = None
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: Optional[List[int]] = None     # as the engine finished them


@dataclasses.dataclass
class StepLog:
    seq: int
    t0: float
    t1: float
    width: int                  # the bucket C
    real: int                   # tokens written
    rows: List[Tuple[int, int, bool]]    # (ctx before, tokens, sampled)
    prefill: bool               # carried a prefilling row


class TimedBackend(PagedEngineBackend):

    def __init__(self, engine, *, clock: Callable[[], float], **kw):
        super().__init__(engine, **kw)
        self.clock = clock
        self.turns: Dict[Tuple[str, str], TurnLog] = {}
        self.live: Dict[int, TurnLog] = {}
        self.steps: List[StepLog] = []
        self.n_steps = 0
        self.pages_peak = 0
        self.step_lock = threading.Lock()

    def expect(self, agent_id: str, prompt: str) -> TurnLog:
        log = self.turns[(agent_id, prompt)] = TurnLog(agent_id, prompt)
        return log

    def begin_turn(self, agent_id: str, context: str, prompt: str) -> int:
        t = self.clock()
        rid = super().begin_turn(agent_id, context, prompt)
        log = self.turns[(agent_id, prompt)]
        log.t_begin = t
        self.live[rid] = log
        return rid

    def step(self):
        eng = self.engine
        with self.step_lock:
            pending = {r.rid: len(r.pending)
                       for r in (*eng.active.values(), *eng._queue)}
            real0, disp0 = eng.tokens_real, eng.tokens_dispatched
            seq = self.n_steps
            self.n_steps += 1
            t0 = self.clock()
            report = super().step()
            t1 = self.clock()
            self.pages_peak = max(self.pages_peak,
                                  eng.cache.allocator.num_used)
            width = (eng.tokens_dispatched - disp0) // eng.max_batch
            rows = []
            for rid, t in report.serviced.items():
                req, log = eng.reqs.get(rid), self.live.get(rid)
                n = len(req.out_tokens) if req is not None else 0
                sampled = log is not None and n > len(log.stamps)
                if sampled:
                    log.stamps.extend([t1] * (n - len(log.stamps)))
                if req is not None and req.table is not None:
                    rows.append((req.num_tokens - t, t, sampled))
            for rid in report.finished:
                log = self.live.pop(rid, None)
                if log is not None:
                    log.tokens = list(eng.reqs[rid].out_tokens)
            if width:
                self.steps.append(StepLog(
                    seq, t0, t1, width, eng.tokens_real - real0, rows,
                    any(pending.get(rid, 0) > 0 for rid in report.serviced)))
            return report


@dataclasses.dataclass
class Stack:
    cfg: ModelConfig
    engine: PagedInferenceEngine
    backend: TimedBackend
    rm: AgentRM
    compile_s: float

    def close(self):
        """Stop AgentRM's threads and wait for them."""
        self.rm.shutdown()
        for t in (self.rm._dispatcher, self.rm._reaper):
            t.join(timeout=30)
            if t.is_alive():
                raise RuntimeError(f"AgentRM thread {t.name} did not stop")


def build(conf: Dict, cfg: ModelConfig, mix: Dict, raw: Dict, device, *,
          clock) -> Stack:
    """``cfg``: the program's ``ModelConfig`` for ``conf``, as its kind
    maps it."""
    params = prepare_params(raw, cfg, device)
    e = conf["engine"]
    engine = PagedInferenceEngine(
        cfg, params, num_blocks=int(e["num_blocks"]),
        block_size=e["block_size"], max_batch=e["max_batch"],
        max_len=e["max_len"], prefill_chunk=e["prefill_chunk"],
        token_budget=e["token_budget"], megastep=True, device=device)
    t0 = time.perf_counter()
    engine.compile_buckets()
    compile_s = time.perf_counter() - t0
    backend = TimedBackend(
        engine, clock=clock,
        max_new_tokens=int(mix["max_new_tokens"]),
        prompt_tokens=int(mix["prompt_tokens"]),
        new_tokens_jitter=int(mix["new_tokens_jitter"]))
    a = conf["agentrm"]
    rm = AgentRM(backend, AgentRMConfig(
        lanes=a["lanes"], detect_after_s=a["detect_after_s"],
        token_rate=a["token_rate"], token_burst=a["token_burst"],
        step_deadline_s=a["step_deadline_s"], autopilot=a["autopilot"]))
    return Stack(cfg, engine, backend, rm, compile_s)
