"""JAX engine adapters for the AgentRM middleware.

``PagedEngineBackend`` is the production adapter: it implements the
middleware's **iteration-level** ``SteppableBackend`` contract (submit/poll
sessions, one ``step()`` over the whole decode batch) so the fused MLFQ
dispatcher — not a thread pool — owns the inference loop. One retained paged
session per agent: first turn prefills (chunked), later turns ``extend`` the
session, preemption parks it in place, hibernation swaps its pages. Under
the engine's megastep an iteration is ONE jitted dispatch, so the whole
``StepReport`` — per-rid token service for MLFQ charging, finished turns,
per-sequence OOM casualties — is accounted from a single model call per
scheduling pass.

``SerializedPagedBackend`` is the same engine behind the legacy turn-level
``generate`` contract: a backend-wide lock held for the whole decode loop,
so turns serialize through an engine built for continuous batching. It
exists as the *baseline* the live scheduling benchmark measures the fused
dispatcher against (and as the reference for the old reap-mid-decode
semantics).

``EngineBackend`` adapts the dense slot engine the same turn-level way.
"""
from __future__ import annotations

import threading
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.core.middleware import (ModelBackend, StepReport,
                                   SteppableBackend, ZombieKilled)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.errors import EngineError, SwapIOError

__all__ = ["byte_tokenize", "EngineBackend", "EngineError",
           "PagedEngineBackend", "SerializedPagedBackend"]


def byte_tokenize(text: str, vocab: int, max_len: int = 96) -> np.ndarray:
    toks = np.frombuffer(text.encode("utf-8", "ignore"), dtype=np.uint8)
    return (toks[:max_len].astype(np.int32) % max(vocab - 2, 2)) + 1


def _jittered_new_tokens(base: int, jitter: int, agent_id: str) -> int:
    """Deterministic per-agent spread of generation lengths
    (base .. base + jitter): real agent fleets do not finish turns in
    lockstep, and the benchmark's mixed scenario needs that desync so
    prefill genuinely overlaps decode."""
    if not jitter:
        return base
    return base + zlib.crc32(agent_id.encode()) % (jitter + 1)


class PagedEngineBackend(SteppableBackend):
    """Session surface of the paged engine for the fused dispatcher.

    All engine access is serialized by a backend lock — the dispatcher
    thread drives ``step``/``begin_turn``/``park_turn``/..., while
    ``hibernate_session``/``wake_session`` may arrive from user threads
    (CLM tier transitions). Lock order is middleware-lock -> engine-lock,
    never the reverse.
    """

    PROMPT_TOKENS = 48

    def __init__(self, engine, max_new_tokens: int = 12,
                 prompt_tokens: int = 0, new_tokens_jitter: int = 0,
                 journal=None, engine_factory: Callable = None):
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        # prompt cap in tokens; 0 keeps the class default. Long-prompt
        # workloads (the prefill-heavy benchmark scenario) raise it so the
        # token-budget packer actually has multi-chunk prompts to size
        # against — it must stay under the engine's max_len minus headroom
        # for generations on a retained session.
        self.prompt_tokens = prompt_tokens or self.PROMPT_TOKENS
        # per-agent generation-length spread (see _jittered_new_tokens)
        self.new_tokens_jitter = new_tokens_jitter
        # crash-safe recovery (DESIGN.md §14): with a SessionJournal each
        # finished turn is committed (atomic publish, checksummed) before
        # collect() acknowledges it, and an engine_factory lets rebuild()
        # tear the engine down and restore every journaled session
        # bit-exactly. Both default off: zero overhead unless asked for.
        self.journal = journal
        self.engine_factory = engine_factory
        self.sessions: dict = {}            # agent_id -> rid
        self._agent_of: dict = {}           # rid -> agent_id (journal key)
        self._lock = threading.Lock()

    @property
    def obs(self):
        """The engine's observability context — AgentRM adopts it when not
        handed one, so the fused stack shares a single ring/registry/clock."""
        return self.engine.obs

    def _tokenize(self, prompt: str) -> np.ndarray:
        return byte_tokenize(prompt, self.engine.cfg.vocab_size,
                             max_len=self.prompt_tokens)

    # --------------------------------------------- SteppableBackend
    def begin_turn(self, agent_id: str, context: str, prompt: str) -> int:
        toks = self._tokenize(prompt)
        n_new = _jittered_new_tokens(self.max_new_tokens,
                                     self.new_tokens_jitter, agent_id)
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None or rid not in self.engine.reqs:
                rid = None
                if self.journal is not None:
                    # a session lost engine-side (swap corruption, crash)
                    # resumes from its last committed state instead of
                    # starting cold — the journal is the source of truth
                    payload = self.journal.load(agent_id)
                    if payload is not None:
                        rid = self.engine.restore_session(payload)
                        self.engine.extend(rid, toks, n_new)
                if rid is None:
                    rid = self.engine.submit(toks, n_new, retain=True)
                self.sessions[agent_id] = rid
                self._agent_of[rid] = agent_id
            else:
                self.engine.extend(rid, toks, n_new)
            return rid

    def step(self) -> StepReport:
        with self._lock:
            try:
                fins = self.engine.step()
            except EngineError:
                raise                # already typed — class carries policy
            except Exception as e:
                raise EngineError(f"paged engine step failed: {e}") from e
            return StepReport(
                serviced=dict(self.engine.last_serviced),
                finished=[r.rid for r in fins],
                failed=[(rid, err if isinstance(err, EngineError)
                         else EngineError(str(err)))
                        for rid, err in self.engine.last_failures],
                waiting=[r.rid for r in self.engine._queue])

    def collect(self, rid: int) -> str:
        with self._lock:
            req = self.engine.reqs.get(rid)
            if req is None or not req.done:
                raise EngineError(f"rid {rid} has no finished turn to collect")
            if self.journal is not None:
                # commit point: the turn's session state (exact page bytes)
                # is published atomically BEFORE the result is handed back,
                # so anything the caller acts on is recoverable
                agent_id = self._agent_of.get(rid)
                payload = self.engine.export_session(rid)
                if agent_id is not None and payload is not None:
                    self.journal.commit(agent_id, payload)
            return "tok:" + ",".join(str(t) for t in req.out_tokens)

    def rebuild(self) -> bool:
        """Tear down and rebuild the engine after a fatal fault, restoring
        every journaled session bit-exactly (pages re-enter through the
        checksummed swap path). Returns False when not configured for
        recovery (no factory/journal) — the caller falls back to failing
        the affected turns. In-flight (uncommitted) turns are NOT here by
        construction; the dispatcher replays them."""
        if self.engine_factory is None or self.journal is None:
            return False
        with self._lock:
            eng = self.engine_factory()
            # the swap store may be shared across engine generations
            # (chaos rebuilds): evict the dead generation's entries
            # BEFORE restoring, or its orphaned rid-keyed payloads
            # collide with the new engine's rid space in ``adopt``
            purge = getattr(getattr(self.engine, "swap", None),
                            "purge_all", None)
            if purge is not None:
                try:
                    purge()
                except BaseException:  # noqa: BLE001 — best-effort
                    pass
            sessions: dict = {}
            agent_of: dict = {}
            for agent_id, payload in self.journal.load_all().items():
                try:
                    rid = eng.restore_session(payload)
                except BaseException:  # noqa: BLE001
                    # a corrupt/poisoned journal payload costs that ONE
                    # session its KV (the next begin_turn starts it
                    # fresh) — never the whole rebuild. Aborting here
                    # used to strand the middleware's parked turns with
                    # rids from an engine this method had already
                    # replaced: stale handles into a reset rid space
                    continue
                sessions[agent_id] = rid
                agent_of[rid] = agent_id
            # commit only after the new engine is fully populated, so a
            # factory failure leaves the old engine — and every parked
            # rid pointing into it — untouched
            self.engine = eng
            self.sessions = sessions
            self._agent_of = agent_of
            return True

    def park_turn(self, rid: int):
        with self._lock:
            self.engine.park(rid)

    def resume_turn(self, rid: int):
        with self._lock:
            self.engine.resume(rid)

    def abort_turn(self, rid: int):
        with self._lock:
            self.engine.abort_turn(rid)

    def session_busy(self, agent_id: str) -> bool:
        """One in-flight turn per session: a second turn for the same agent
        waits (rotated by the dispatcher) until the first parks it."""
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None or rid not in self.engine.reqs:
                return False
            req = self.engine.reqs[rid]
            return req.state not in ("parked", "swapped") or not req.done

    def can_admit(self, agent_id: str, prompt: str) -> bool:
        """Gate MLFQ dequeue on the engine's *budget-aware* first-chunk
        reservation: the engine reserves blocks only for what the first
        dispatch can actually write (min of prompt, chunk, token budget)."""
        with self._lock:
            n = min(len(prompt.encode("utf-8", "ignore")),
                    self.prompt_tokens)
            return self.engine.can_admit(max(n, 1))

    # ------------------------------------------- hibernation contract
    def hibernate_session(self, agent_id: str):
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None or rid not in self.engine.reqs:
                return
            req = self.engine.reqs[rid]
            if req.state == "active" or not req.done:
                # never rip a mid-turn sequence out from under the fused
                # dispatcher — the CLM tier transition waits for the park
                return
            self.engine.hibernate(rid)

    def wake_session(self, agent_id: str):
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None:
                return
            try:
                self.engine.wake(rid)
            except SwapIOError:
                # the swapped payload is junk (checksum/IO failure): drop
                # the engine-side session — the next begin_turn restores it
                # from the journal when one exists, or starts it fresh
                self.sessions.pop(agent_id, None)
                self._agent_of.pop(rid, None)
                if rid in self.engine.reqs:
                    self.engine.release(rid)

    # --------------------------------------------- fleet/migration hooks
    def victim_parkable(self, rid: int) -> bool:
        """Degradation victim filter: only an ACTIVE sequence frees blocks
        when parked + hibernated — a parked/swapped/queued one is already
        cold (or not resident yet) and picking it would stall admission
        for a full retry cycle."""
        with self._lock:
            req = self.engine.reqs.get(rid)
            return req is not None and req.state == "active"

    def idle_sessions(self):
        """Sudden-migration candidate set: sessions whose turn is done and
        whose pages are parked or swapped, as ``(agent_id, rid, resident_
        pages)`` sorted largest-resident-first (migrating those frees the
        most source blocks)."""
        with self._lock:
            out = []
            for agent_id, rid in self.sessions.items():
                req = self.engine.reqs.get(rid)
                if (req is not None and req.done
                        and req.state in ("parked", "swapped")):
                    pages = (req.table.num_pages
                             if req.table is not None else 0)
                    out.append((agent_id, rid, pages))
            out.sort(key=lambda t: -t[2])
            return out

    def evict_session(self, agent_id: str, pages=None):
        """Source half of a migration: remove the session from this
        backend and return its ``export_live`` payload (None if unknown
        or mid-dispatch). ``pages`` forwards pre-assembled host pages so
        fluid migration doesn't re-gather what it already streamed."""
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None:
                return None
            payload = self.engine.export_live(rid, pages=pages)
            if payload is None:
                return None
            self.engine.release(rid)
            self.sessions.pop(agent_id, None)
            self._agent_of.pop(rid, None)
            return payload

    def adopt_session(self, agent_id: str, payload,
                      resume: Optional[bool] = None) -> int:
        """Target half of a migration: import the payload (the session
        lands SWAPPED behind the checksummed swap path) and, when its turn
        is still in flight, queue it to resume decoding bit-exactly.
        ``resume`` overrides the default resume-if-mid-turn: a migrated
        turn the *middleware* had preempted must stay parked, so its own
        ``resume_turn`` remains the single resume."""
        with self._lock:
            rid = self.engine.import_live(payload)
            self.sessions[agent_id] = rid
            self._agent_of[rid] = agent_id
            if resume is None:
                resume = not payload.get("done", True)
            if resume:
                self.engine.resume(rid)
            return rid


class SerializedPagedBackend(ModelBackend):
    """The pre-fusion design, kept as the benchmark baseline: persistent
    paged sessions, but ``generate`` holds a backend-wide lock for the whole
    decode loop — one turn decodes at a time no matter how wide the engine's
    batch is. The middleware runs it on the threaded lane pool. Takes the
    same workload knobs (``prompt_tokens``, ``new_tokens_jitter``) as
    ``PagedEngineBackend`` so baseline comparisons run identical traffic."""

    def __init__(self, engine, max_new_tokens: int = 12,
                 prompt_tokens: int = 0, new_tokens_jitter: int = 0):
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self.prompt_tokens = prompt_tokens or PagedEngineBackend.PROMPT_TOKENS
        self.new_tokens_jitter = new_tokens_jitter
        self.sessions: dict = {}            # agent_id -> rid
        self._lock = threading.Lock()

    @property
    def obs(self):
        return self.engine.obs

    def generate(self, agent_id: str, context: str, prompt: str,
                 heartbeat: Callable[[], None],
                 cancelled: threading.Event) -> str:
        toks = byte_tokenize(prompt, self.engine.cfg.vocab_size,
                             max_len=self.prompt_tokens)
        n_new = _jittered_new_tokens(self.max_new_tokens,
                                     self.new_tokens_jitter, agent_id)
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is None or rid not in self.engine.reqs:
                rid = self.engine.submit(toks, n_new, retain=True)
                self.sessions[agent_id] = rid
            else:
                self.engine.extend(rid, toks, n_new)
            out = None
            try:
                for _ in range(len(toks) + n_new + 8):
                    if cancelled.is_set():
                        raise ZombieKilled(
                            f"turn for {agent_id} reaped mid-decode")
                    heartbeat()
                    for fin in self.engine.step():
                        if fin.rid == rid:
                            out = fin
                    if out is not None:
                        break
            except BaseException:
                # leave the session consistent (parked) so the agent's next
                # turn can extend it; a never-prefilled session is dropped
                self.engine.abort_turn(rid)
                if rid not in self.engine.reqs:
                    self.sessions.pop(agent_id, None)
                raise
            if out is None:
                self.engine.abort_turn(rid)
                raise EngineError(
                    f"paged engine failed to finish turn for {agent_id} "
                    f"(rid {rid})")
        return "tok:" + ",".join(str(t) for t in out.out_tokens)

    # ------------------------------------------- hibernation contract
    def hibernate_session(self, agent_id: str):
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is not None:
                self.engine.hibernate(rid)

    def wake_session(self, agent_id: str):
        with self._lock:
            rid = self.sessions.get(agent_id)
            if rid is not None:
                self.engine.wake(rid)


class EngineBackend(ModelBackend):
    """Serialises middleware turns through a shared dense engine instance.
    One decode step per heartbeat: a stall in XLA shows up as heartbeat
    silence, which is exactly what the reaper watches."""

    def __init__(self, engine: InferenceEngine, max_new_tokens: int = 12):
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self._lock = threading.Lock()

    def generate(self, agent_id: str, context: str, prompt: str,
                 heartbeat: Callable[[], None],
                 cancelled: threading.Event) -> str:
        toks = byte_tokenize(context[-256:] + "\n" + prompt,
                             self.engine.cfg.vocab_size)
        with self._lock:
            rid = self.engine.submit(toks, max_new_tokens=self.max_new_tokens)
            out = None
            for _ in range(self.max_new_tokens + 4):
                if cancelled.is_set():
                    raise ZombieKilled(f"turn for {agent_id} reaped mid-decode")
                heartbeat()
                for fin in self.engine.step():
                    if fin.rid == rid:
                        out = fin
                if out is not None:
                    break
        if out is None:
            raise EngineError(f"dense engine failed to finish request "
                              f"for {agent_id} (rid {rid})")
        return "tok:" + ",".join(str(t) for t in out.out_tokens)
