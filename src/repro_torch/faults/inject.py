"""Fault injectors: a faulty swap tier and a chaos-wrapping backend.

``ChaosBackend`` wraps a ``PagedEngineBackend`` and fires a ``FaultPlan``'s
faults as the dispatcher drives ``step()``. Every injection goes through
the stack's real failure surfaces — the same exceptions, the same code
paths — so the soak exercises exactly the handling production would need.

Two injection rules keep the chaos itself honest:

* A hung step sleeps and then RAISES ``TransientStepError`` — it never
  runs a real engine step after the sleep. The dispatcher's watchdog
  abandons the wedged worker thread; if that thread later woke up and
  stepped the engine, it could double-step a rebuilt engine behind the
  dispatcher's back. Raising keeps abandoned threads inert.
* Injected step faults fire BEFORE the inner step, never mid-step, so
  engine state is untouched when the exception surfaces — matching the
  contract the retry tier assumes (a failed step serviced nothing).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.context.tiers import KVSwapStore
from repro_torch.core.middleware import SteppableBackend, StepReport
from repro_torch.faults.plan import FAULT_KINDS, FaultPlan, FaultSpec
from repro_torch.serving.errors import (EngineCrashError, SwapIOError,
                                  TransientStepError)

__all__ = ["FaultyKVSwapStore", "ChaosBackend"]


class FaultyKVSwapStore(KVSwapStore):
    """Swap tier with armed one-shot IO failures and byte corruption.

    ``fail_next_put`` / ``fail_next_read`` are counters: each armed unit
    makes the next matching operation raise ``SwapIOError`` (consumed
    whether or not anything catches it). ``corrupt_one`` flips a byte of
    an already-stored payload in place — the SwapManager's checksum (or
    the journal's) detects it at read time."""

    def __init__(self):
        super().__init__()
        self.fail_next_put = 0
        self.fail_next_read = 0
        self.io_faults_fired = 0
        self.corruptions_injected = 0

    def _maybe_fail(self, armed_attr: str, op: str, key):
        if getattr(self, armed_attr) > 0:
            setattr(self, armed_attr, getattr(self, armed_attr) - 1)
            self.io_faults_fired += 1
            raise SwapIOError(f"injected swap-store {op} failure for {key!r}")

    def put(self, key, payload, nbytes: int):
        self._maybe_fail("fail_next_put", "write", key)
        super().put(key, payload, nbytes)

    def peek(self, key):
        self._maybe_fail("fail_next_read", "read", key)
        return super().peek(key)

    def pop(self, key):
        # peek() already consumed the armed read fault for a normal
        # swap-in (peek then pop); an armed fault still pending here
        # covers direct pops (discard paths don't re-raise).
        self._maybe_fail("fail_next_read", "read", key)
        return super().pop(key)

    def corrupt_one(self, pick: int = 0) -> Optional[object]:
        """Flip one byte of a stored payload (deterministic victim:
        ``pick``-th key in insertion order). Returns the victim key, or
        None if nothing is swapped out."""
        keys = list(self._pages)
        if not keys:
            return None
        key = keys[pick % len(keys)]
        k_pages, v_pages, num_tokens = self._pages[key]
        k_pages = np.array(k_pages, copy=True)
        flat = k_pages.reshape(-1).view(np.uint8)
        flat[pick % flat.size] ^= 0xFF
        self._pages[key] = (k_pages, v_pages, num_tokens)
        self.corruptions_injected += 1
        return key


class ChaosBackend(SteppableBackend):
    """Wrap a ``PagedEngineBackend``; fire ``plan``'s faults by step index.

    ``on_rate_limit`` should be wired to ``AgentRM.report_rate_limited``
    so injected 429 bursts feed the real AIMD admission controller.
    """

    # how long a kv_squat holds its hostage blocks, in backend steps
    SQUAT_STEPS = 4

    def __init__(self, inner, plan: FaultPlan,
                 store: Optional[FaultyKVSwapStore] = None):
        self.inner = inner
        self.plan = plan
        self.store = store                      # the engine's swap store
        self.on_rate_limit = None               # set by the harness
        self.step_idx = 0
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._squat: List[int] = []             # hostage block ids
        # the allocator the hostages came from: with a FLEET inner,
        # ``self.engine`` re-resolves to the first ALIVE member and can
        # point at a DIFFERENT engine by release time (after a loss) —
        # releasing the ids there would corrupt an innocent allocator
        self._squat_alloc = None
        self._squat_release_at = -1

    # ----------------------------------------------------- delegation
    @property
    def engine(self):
        return self.inner.engine

    @property
    def sessions(self):
        return self.inner.sessions

    @property
    def obs(self):
        return self.inner.obs

    def begin_turn(self, agent_id: str, context: str, prompt: str) -> int:
        return self.inner.begin_turn(agent_id, context, prompt)

    def session_busy(self, agent_id: str) -> bool:
        return self.inner.session_busy(agent_id)

    def collect(self, rid: int) -> str:
        return self.inner.collect(rid)

    def park_turn(self, rid: int):
        self.inner.park_turn(rid)

    def resume_turn(self, rid: int):
        self.inner.resume_turn(rid)

    def abort_turn(self, rid: int):
        self.inner.abort_turn(rid)

    def can_admit(self, agent_id: str, prompt: str) -> bool:
        return self.inner.can_admit(agent_id, prompt)

    def victim_parkable(self, rid: int) -> bool:
        hook = getattr(self.inner, "victim_parkable", None)
        return True if hook is None else hook(rid)

    def rebalance_for_admission(self, agent_id: str, prompt: str) -> bool:
        hook = getattr(self.inner, "rebalance_for_admission", None)
        return False if hook is None else hook(agent_id, prompt)

    def hibernate_session(self, agent_id: str):
        self.inner.hibernate_session(agent_id)

    def wake_session(self, agent_id: str):
        self.inner.wake_session(agent_id)

    def idle_sessions(self):
        """Duck-typed pass-through so the overload autopilot's hibernate
        rung sees the inner backend's idle candidates under chaos."""
        hook = getattr(self.inner, "idle_sessions", None)
        return [] if hook is None else hook()

    def rebuild(self) -> bool:
        # hostage blocks belong to the torn-down engine's allocator —
        # dropping the ids is correct, freeing them into the new one isn't
        self._squat = []
        self._squat_alloc = None
        self._squat_release_at = -1
        return self.inner.rebuild()

    # ------------------------------------------------------ injection
    def release_squat(self):
        if self._squat and self._squat_alloc is not None:
            self._squat_alloc.release_many(self._squat)
        self._squat = []
        self._squat_alloc = None
        self._squat_release_at = -1

    def step(self) -> StepReport:
        idx = self.step_idx
        self.step_idx += 1
        if self._squat and idx >= self._squat_release_at:
            self.release_squat()
        for f in self.plan.at(idx):
            self._apply(f)                      # may raise (that's the point)
        return self.inner.step()

    def _apply(self, f: FaultSpec):
        self.injected[f.kind] += 1
        engine = self.inner.engine
        if f.kind == "step_exception":
            raise TransientStepError("injected transient step fault "
                                     f"@step {f.step}")
        if f.kind == "step_hang":
            time.sleep(f.param)
            # NEVER step after the sleep — see module docstring
            raise TransientStepError("injected hung step (abandoned) "
                                     f"@step {f.step}")
        if f.kind == "crash":
            raise EngineCrashError(f"injected engine crash @step {f.step}")
        if f.kind == "poison_row":
            active = sorted(engine.active)
            if active:
                engine.inject_poison(active[int(f.param) % len(active)])
            else:
                self.injected[f.kind] -= 1      # nothing to poison: no-op
            return
        if f.kind == "kv_squat":
            if self._squat:                     # previous squat still live
                self.release_squat()
            alloc = engine.cache.allocator
            n = int(alloc.num_free * min(max(f.param, 0.0), 0.9))
            if n > 0:
                self._squat = alloc.alloc_many(n)
                self._squat_alloc = alloc
                self._squat_release_at = self.step_idx + self.SQUAT_STEPS
            else:
                self.injected[f.kind] -= 1
            return
        if f.kind == "swap_write_error":
            if self.store is not None:
                self.store.fail_next_put += 1
            return
        if f.kind == "swap_read_error":
            if self.store is not None:
                self.store.fail_next_read += 1
            return
        if f.kind == "swap_corrupt":
            if self.store is None or self.store.corrupt_one(f.step) is None:
                self.injected[f.kind] -= 1
            return
        if f.kind == "rate_limit":
            if self.on_rate_limit is not None:
                self.on_rate_limit(int(f.param))
            return
        # fleet kinds: dispatched through duck-typed hooks so the same
        # plan runs against a single engine (no hook -> counted no-op)
        if f.kind == "engine_loss":
            hook = getattr(self.inner, "inject_engine_loss", None)
            if hook is None or not hook(f.param):
                self.injected[f.kind] -= 1
            return
        if f.kind == "migration_interrupt":
            hook = getattr(self.inner, "interrupt_migrations", None)
            if hook is None or not hook():
                self.injected[f.kind] -= 1
            return
        if f.kind == "network_delay":
            hook = getattr(self.inner, "set_network_delay", None)
            if hook is None or not hook(f.param):
                self.injected[f.kind] -= 1
            return
        raise ValueError(f"unknown fault kind {f.kind!r}")
