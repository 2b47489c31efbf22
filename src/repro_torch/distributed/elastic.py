"""Elastic engine fleet: placement, live KV-page migration, failover
(DESIGN.md §15 — ROADMAP item #2, the cluster story).

A ``FleetBackend`` puts N ``PagedInferenceEngine`` instances — each
keeping the one-dispatch-per-step megastep contract, each optionally on
its own TP mesh — behind the single ``SteppableBackend`` surface the
fused dispatcher already drives. The fleet owns:

  * **Placement** — agents are sticky-homed to the least-loaded active
    engine at first admission; a dead/drained home re-places lazily.
  * **Migration** — sessions move between engines as exact KV-page
    bytes. The slow baseline ("sudden") is evict-on-source →
    adopt-on-target through the checksummed swap path, only legal for
    idle sessions. The headline ("fluid") migrates a session whose turn
    is *still decoding*: content-frozen full pages stream to host
    buffers tick by tick while the source keeps serving tokens, and a
    bounded stop-the-session handoff moves only the remaining tail
    (``fluid_handoff_pages`` pages). Correctness rides on a pool
    invariant: decode only appends past ``num_tokens`` and COW
    ``_unshare`` swaps the *tail* block id, so a full block's content
    never changes under a live session — streaming by page index is
    race-free.
  * **Failover** — when an engine is lost (``ChaosBackend``'s
    ``engine_loss`` fault, or ``kill_engine``), its in-flight turns fail
    with typed ``EngineLostError`` in that step's report, and its
    journaled sessions re-home lazily: the next ``begin_turn`` on a
    survivor restores them bit-exactly from the shared write-ahead
    ``SessionJournal``.
  * **Graceful drain** — ``drain(idx)`` removes an engine from
    placement, migrates its idle sessions immediately and the rest as
    their turns finish; the member leaves as "drained", losing nothing.
  * **Rebalancing** — the middleware's ``rebalance_for_admission`` hook
    lands here: under KV pressure the fleet first migrates a cold
    session to an engine with *device headroom* (so it can actually
    wake there), and only when no engine has headroom does the
    middleware fall back to hibernate-the-victim degradation.

Migration state machine (per session)::

    IDLE --start_fluid--> STREAMING --(remaining <= handoff)--> HANDOFF
      STREAMING: gather_range(sent, hi) -> host buffer; source decodes on
      HANDOFF:   park -> gather tail -> assemble -> adopt (checksummed
                 swap path) -> remap ext rid -> release(source) -> resume
    aborts (interrupt fault, vanished session, dead endpoint) only take
    effect in STREAMING: buffers drop, the source session is untouched,
    zero blocks change hands. HANDOFF runs atomically under the fleet
    lock — the target allocates *device* blocks only at wake, so an
    interrupted migration can never leak blocks on either side.

Failure semantics per phase: a member whose ``step`` raises a transient
error is skipped (its turns heartbeat as waiting) and retried; after
``member_retry_budget`` consecutive failures — or on any fatal error —
its in-flight turns fail typed and the member rebuilds in place from
the journal, dying into failover if it can't. ``step`` raises only when
the last engine is gone, which is when the middleware's own rebuild
escalation takes over via ``rebuild()``.

``reshard_params`` / ``elastic_restore`` (the across-restart re-meshing
helpers) remain re-exported: they are the per-engine half of
elasticity; this module is the fleet half.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.middleware import StepReport, SteppableBackend
from repro_torch.distributed.sharding import elastic_restore, reshard_params
from repro_torch.obs import LATENCY_BUCKETS_S
from repro_torch.serving.errors import (EngineCrashError, EngineError,
                                  EngineLostError, MigrationError,
                                  is_transient)

__all__ = ["FleetBackend", "FleetMember", "FluidMigration",
           "reshard_params", "elastic_restore"]

M_ACTIVE, M_DRAINING, M_DRAINED, M_DEAD = \
    "active", "draining", "drained", "dead"


class FleetMember:
    """One engine slot in the fleet: a ``PagedEngineBackend`` plus
    membership state and the transient-failure streak."""

    def __init__(self, idx: int, backend):
        self.idx = idx
        self.backend = backend
        self.state = M_ACTIVE
        self.consec_failures = 0

    @property
    def alive(self) -> bool:
        """Still stepping: active or draining (drained/dead members are
        out of the loop)."""
        return self.state in (M_ACTIVE, M_DRAINING)


class FluidMigration:
    """In-flight fluid migration record (one per session)."""

    def __init__(self, agent_id: str, src: int, dst: int):
        self.agent_id = agent_id
        self.src = src
        self.dst = dst
        self.chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self.pages_sent = 0
        self.phase = "streaming"            # streaming | done | aborted
        self.stall_s: Optional[float] = None
        self.error: Optional[MigrationError] = None


class FleetBackend(SteppableBackend):
    """N paged-engine backends behind one ``SteppableBackend`` surface.

    The middleware keeps driving exactly the protocol it already knows;
    every rid it sees is a fleet-level *external* rid that survives the
    session moving engines (``_fwd``/``_rev`` remap at handoff, so a
    parked turn resumes on whichever engine holds the session now).
    All fleet calls take one re-entrant lock; per-member backends keep
    their own.
    """

    member_retry_budget = 3       # consecutive transient member faults

    def __init__(self, backends, *, journal=None,
                 fluid_pages_per_tick: int = 4,
                 fluid_handoff_pages: int = 4):
        if not backends:
            raise ValueError("a fleet needs at least one engine backend")
        self.members = [FleetMember(i, be) for i, be in enumerate(backends)]
        self.journal = journal
        self.fluid_pages_per_tick = max(1, int(fluid_pages_per_tick))
        self.fluid_handoff_pages = max(1, int(fluid_handoff_pages))
        self._lock = threading.RLock()
        self._home: Dict[str, int] = {}             # agent -> member idx
        self._fwd: Dict[int, Tuple[int, int]] = {}  # ext -> (midx, rid)
        self._rev: Dict[Tuple[int, int], int] = {}  # (midx, rid) -> ext
        self._next_ext = 1
        self._migrations: Dict[str, FluidMigration] = {}
        self.last_migration: Optional[FluidMigration] = None
        # chaos hooks arm these; step() consumes them
        self._pending_loss: List[int] = []
        self._interrupt_next = False
        self._delay_next_s = 0.0
        # failover bookkeeping for recovery-time measurement
        self.displaced_agents: set = set()
        self.last_engine_loss_t: Optional[float] = None

        m = self.obs.metrics
        self._c_mig_sudden = m.counter("fleet.migrations_sudden")
        self._c_mig_fluid = m.counter("fleet.migrations_fluid")
        self._c_mig_aborted = m.counter("fleet.migrations_aborted")
        self._c_pages = m.counter("fleet.pages_streamed")
        self._c_lost = m.counter("fleet.engines_lost")
        self._c_drained = m.counter("fleet.engines_drained")
        self._c_member_rebuilds = m.counter("fleet.member_rebuilds")
        self._c_failover = m.counter("fleet.sessions_failed_over")
        self._c_rebalance = m.counter("fleet.rebalance_migrations")
        self._c_affinity = m.counter("fleet.affinity_placements")
        self._g_active = m.gauge("fleet.engines_active")
        self.h_handoff = m.histogram("fleet.handoff_s", LATENCY_BUCKETS_S,
                                     reservoir=256)
        rec = self.obs.recorder
        self._tr_fleet = rec.track("migrations", group="fleet")
        self._ev_mig = rec.name("fleet.migration", ("src", "dst", "pages"))
        self._ev_handoff = rec.name("fleet.handoff",
                                    ("src", "dst", "tail_pages"))
        self._ev_loss = rec.name("fleet.engine_lost",
                                 ("idx", "turns_failed"))
        self._ev_drain = rec.name("fleet.drained", ("idx",))
        self._ev_abort = rec.name("fleet.migration_aborted", ("src", "dst"))
        self._g_active.set(float(len(self.members)))

    # ------------------------------------------------------- delegation
    @property
    def obs(self):
        return self.members[0].backend.obs

    @property
    def engine(self):
        """First alive engine — the surface single-engine chaos faults
        (poison, squat) land on: they hit ONE engine, which is the honest
        shape for per-engine blast-radius isolation."""
        for mem in self.members:
            if mem.alive:
                return mem.backend.engine
        return self.members[0].backend.engine

    @property
    def sessions(self) -> Dict[str, int]:
        """agent -> external rid across alive members (diagnostics)."""
        with self._lock:
            out = {}
            for mem in self.members:
                if not mem.alive:
                    continue
                for agent_id, rid in mem.backend.sessions.items():
                    out[agent_id] = self._ext_for(mem.idx, rid)
            return out

    # --------------------------------------------------------- routing
    def _ext_for(self, midx: int, rid: int) -> int:
        key = (midx, rid)
        ext = self._rev.get(key)
        if ext is None:
            ext = self._next_ext
            self._next_ext += 1
            self._rev[key] = ext
            self._fwd[ext] = key
        return ext

    def _route(self, ext: int):
        key = self._fwd.get(ext)
        if key is None:
            return None, None
        mem = self.members[key[0]]
        if not mem.alive:
            return None, None
        return mem, key[1]

    def _active_members(self) -> List[FleetMember]:
        return [m for m in self.members if m.state == M_ACTIVE]

    def _load_key(self, mem: FleetMember):
        # queued admissions count: blocks allocate at prefill, so a burst
        # of begin_turns between steps must still spread across engines
        eng = mem.backend.engine
        return (-eng.cache.allocator.num_free,
                len(eng.active) + len(eng._queue), mem.idx)

    def _prefix_affinity(self, mem: FleetMember, agent_id: str,
                         prompt: Optional[str]) -> int:
        """Dedup-indexed prefix blocks of ``prompt`` this member's pool
        already holds — but only when the member could actually admit the
        turn (affinity toward a full engine would defeat load spreading).
        Best-effort and side-effect-free; 0 for non-paged backends."""
        if not prompt:
            return 0
        tok = getattr(mem.backend, "_tokenize", None)
        probe = getattr(
            getattr(mem.backend.engine, "cache", None),
            "prefix_match_blocks", None)
        if tok is None or probe is None:
            return 0
        try:
            if not mem.backend.can_admit(agent_id, prompt):
                return 0
            return int(probe(tok(prompt)))
        except BaseException:  # noqa: BLE001 — scoring must never fail
            return 0

    def _place_key(self, mem: FleetMember, agent_id: str,
                   prompt: Optional[str]):
        """Placement score, most significant first: prompt-prefix
        affinity (a fleet sharing a system prompt co-locates with the
        engine already holding those blocks — the prefix-dedup index
        turns into cross-session placement signal), then KV headroom,
        then active+queued load, then index for determinism."""
        return (-self._prefix_affinity(mem, agent_id, prompt),
                ) + self._load_key(mem)

    def _place(self, agent_id: str, prompt: Optional[str] = None) -> int:
        midx = self._home.get(agent_id)
        if midx is not None and self.members[midx].state == M_ACTIVE:
            return midx
        cands = self._active_members()
        if not cands:
            raise EngineLostError("no active engines left for placement")
        mem = min(cands,
                  key=lambda m: self._place_key(m, agent_id, prompt))
        if self._prefix_affinity(mem, agent_id, prompt) > 0:
            self._c_affinity.inc()
        if agent_id in self.displaced_agents:
            self.displaced_agents.discard(agent_id)
            self._c_failover.inc()
        self._home[agent_id] = mem.idx
        return mem.idx

    def _update_active_gauge(self):
        self._g_active.set(float(len(self._active_members())))

    # ------------------------------------------ SteppableBackend: admit
    def begin_turn(self, agent_id: str, context: str, prompt: str) -> int:
        with self._lock:
            midx = self._place(agent_id, prompt)
            rid = self.members[midx].backend.begin_turn(
                agent_id, context, prompt)
            return self._ext_for(midx, rid)

    def can_admit(self, agent_id: str, prompt: str) -> bool:
        with self._lock:
            try:
                midx = self._place(agent_id, prompt)
            except EngineLostError:
                return False
            return self.members[midx].backend.can_admit(agent_id, prompt)

    def session_busy(self, agent_id: str) -> bool:
        with self._lock:
            midx = self._home.get(agent_id)
            if midx is None or not self.members[midx].alive:
                return False
            return self.members[midx].backend.session_busy(agent_id)

    # --------------------------------------- SteppableBackend: turn ops
    def collect(self, ext: int) -> str:
        with self._lock:
            mem, rid = self._route(ext)
            if mem is None:
                raise EngineLostError(
                    f"turn {ext}: its engine was lost before collect")
            return mem.backend.collect(rid)

    def park_turn(self, ext: int):
        with self._lock:
            mem, rid = self._route(ext)
            if mem is not None:
                mem.backend.park_turn(rid)

    def resume_turn(self, ext: int):
        with self._lock:
            mem, rid = self._route(ext)
            if mem is None:
                raise EngineLostError(
                    f"turn {ext}: its engine was lost while parked")
            mem.backend.resume_turn(rid)

    def abort_turn(self, ext: int):
        with self._lock:
            mem, rid = self._route(ext)
            if mem is not None:
                mem.backend.abort_turn(rid)

    def victim_parkable(self, ext: int) -> bool:
        with self._lock:
            mem, rid = self._route(ext)
            if mem is None:
                return False
            agent_id = mem.backend._agent_of.get(rid)
            if agent_id is not None and agent_id in self._migrations:
                return False            # mid-migration: hands off
            return mem.backend.victim_parkable(rid)

    # ------------------------------------------ SteppableBackend: step
    def step(self) -> StepReport:
        with self._lock:
            serviced: Dict[int, int] = {}
            finished: List[int] = []
            failed: List[Tuple[int, BaseException]] = []
            waiting: List[int] = []
            self._process_pending_losses(failed)
            self._tick_migrations()
            for mem in list(self.members):
                if not mem.alive:
                    continue
                try:
                    rep = mem.backend.step()
                except BaseException as e:  # noqa: BLE001 — member fault
                    waiting.extend(self._member_failed(mem, e, failed))
                    continue
                mem.consec_failures = 0
                for rid, n in rep.serviced.items():
                    serviced[self._ext_for(mem.idx, rid)] = n
                finished.extend(self._ext_for(mem.idx, r)
                                for r in rep.finished)
                failed.extend((self._ext_for(mem.idx, r), err)
                              for r, err in rep.failed)
                waiting.extend(self._ext_for(mem.idx, r)
                               for r in rep.waiting)
                if mem.state == M_DRAINING:
                    self._drain_tick(mem)
            if not any(m.alive for m in self.members):
                raise EngineLostError(
                    "every engine in the fleet is dead — rebuild required")
            return StepReport(serviced=serviced, finished=finished,
                              failed=failed, waiting=waiting)

    def _member_failed(self, mem: FleetMember, exc: BaseException,
                       failed: List[Tuple[int, BaseException]]) -> List[int]:
        """One member's step raised. Transient within budget: skip it this
        pass and heartbeat its turns. Otherwise its in-flight turns fail
        typed, then the member rebuilds in place (journal restore) or
        dies into failover. Returns ext rids to report as waiting."""
        mem.consec_failures += 1
        if (is_transient(exc)
                and mem.consec_failures <= self.member_retry_budget):
            return [ext for (midx, _), ext in self._rev.items()
                    if midx == mem.idx]
        err = (exc if isinstance(exc, EngineError)
               else EngineCrashError(f"engine {mem.idx} died: {exc!r}"))
        self._fail_member_turns(mem, failed, err)
        rebuilt = False
        try:
            rebuilt = bool(mem.backend.rebuild())
        except BaseException:  # noqa: BLE001 — rebuild itself died
            rebuilt = False
        if rebuilt:
            mem.consec_failures = 0
            self._c_member_rebuilds.inc()
        else:
            self._kill_member(mem, failed, turns_already_failed=True)
        return []

    def _fail_member_turns(self, mem: FleetMember,
                           failed: List[Tuple[int, BaseException]],
                           err: EngineError):
        """Fail every routed turn on a member typed, and drop the routes
        (the engine-side state behind them is gone)."""
        for (midx, rid), ext in list(self._rev.items()):
            if midx != mem.idx:
                continue
            failed.append((ext, err))
            del self._rev[(midx, rid)]
            del self._fwd[ext]

    # -------------------------------------------------- loss / failover
    def inject_engine_loss(self, pick: float) -> bool:
        """Chaos hook (``engine_loss`` fault): arm the pick-th alive
        member to die at the next step. Refuses to take the last one."""
        with self._lock:
            if len([m for m in self.members if m.alive]) <= 1:
                return False
            self._pending_loss.append(int(pick))
            return True

    def kill_engine(self, idx: int) -> bool:
        """Kill a specific member at the next step (tests/demos). The
        failures surface in that step's report, exactly as a real loss
        would."""
        with self._lock:
            mem = self.members[idx]
            if not mem.alive:
                return False
            if not [m for m in self.members if m.alive and m.idx != idx]:
                return False
            self._pending_loss.append(-(idx + 1))   # negative = exact idx
            return True

    def _process_pending_losses(self,
                                failed: List[Tuple[int, BaseException]]):
        for pick in self._pending_loss:
            alive = [m for m in self.members if m.alive]
            if len(alive) <= 1:
                continue                 # never take the last engine
            if pick < 0:
                victim = self.members[-pick - 1]
                if not victim.alive:
                    continue
            else:
                victim = alive[pick % len(alive)]
            self._kill_member(victim, failed)
        self._pending_loss.clear()

    def _kill_member(self, mem: FleetMember,
                     failed: List[Tuple[int, BaseException]],
                     turns_already_failed: bool = False):
        mem.state = M_DEAD
        self._c_lost.inc()
        self.last_engine_loss_t = time.monotonic()
        # migrations touching the corpse abort — streaming-phase only by
        # construction, since handoff is atomic under this same lock
        for mig in list(self._migrations.values()):
            if mig.src == mem.idx or mig.dst == mem.idx:
                self._abort_migration(
                    mig, f"engine {mem.idx} died mid-migration")
        n_before = len(failed)
        if not turns_already_failed:
            self._fail_member_turns(
                mem, failed,
                EngineLostError(f"engine {mem.idx} "
                                f"({mem.backend.engine.name}) lost"))
        for agent_id, home in list(self._home.items()):
            if home == mem.idx:
                del self._home[agent_id]
                self.displaced_agents.add(agent_id)
        self._update_active_gauge()
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_loss, self._tr_fleet, mem.idx,
                        len(failed) - n_before)

    def rebuild(self) -> bool:
        """Middleware escalation target (reached only when the whole fleet
        is dead): rebuild every dead member from the shared journal."""
        with self._lock:
            ok = False
            for mem in self.members:
                if mem.state == M_DEAD:
                    rebuilt = False
                    try:
                        rebuilt = bool(mem.backend.rebuild())
                    except BaseException:  # noqa: BLE001
                        rebuilt = False
                    if rebuilt:
                        mem.state = M_ACTIVE
                        mem.consec_failures = 0
                        ok = True
                elif mem.alive:
                    ok = True
            self._update_active_gauge()
            return ok

    # ------------------------------------------------------- migration
    def migrate(self, agent_id: str, target_idx: int,
                fluid: bool = False) -> Optional[dict]:
        """Move a session to ``target_idx``. Idle sessions move suddenly
        (one evict→adopt through the checksummed swap path); a mid-turn
        session needs ``fluid=True`` and streams over subsequent
        ``step``s. Returns None when there is nothing to move (unknown
        agent, same engine, dead endpoint, busy without fluid)."""
        with self._lock:
            midx = self._home.get(agent_id)
            if midx is None or midx == target_idx:
                return None
            src, dst = self.members[midx], self.members[target_idx]
            if not src.alive or dst.state != M_ACTIVE:
                return None
            if agent_id in self._migrations:
                return None
            if src.backend.session_busy(agent_id):
                if not fluid:
                    return None
                mig = FluidMigration(agent_id, src.idx, dst.idx)
                self._migrations[agent_id] = mig
                self.last_migration = mig
                return {"agent": agent_id, "mode": "fluid"}
            t0 = time.perf_counter()
            rid = src.backend.sessions.get(agent_id)
            payload = src.backend.evict_session(agent_id)
            if payload is None:
                return None
            new_rid = dst.backend.adopt_session(agent_id, payload,
                                                resume=False)
            # remap the external rid (same as the fluid handoff): an idle
            # session can still owe a finished-but-uncollected turn, and
            # its collect must follow the session to the target
            ext = self._rev.pop((src.idx, rid), None)
            if ext is not None:
                self._fwd[ext] = (dst.idx, new_rid)
                self._rev[(dst.idx, new_rid)] = ext
            self._home[agent_id] = dst.idx
            self._c_mig_sudden.inc()
            pages = int(payload["k_pages"].shape[1])
            rec = self.obs.recorder
            if rec.enabled:
                rec.complete(self._ev_mig, self._tr_fleet, t0,
                             src.idx, dst.idx, pages)
            return {"agent": agent_id, "mode": "sudden", "pages": pages,
                    "stall_s": time.perf_counter() - t0}

    def migration_active(self, agent_id: str) -> bool:
        with self._lock:
            return agent_id in self._migrations

    # chaos hooks ------------------------------------------------------
    def interrupt_migrations(self) -> bool:
        """Chaos hook (``migration_interrupt``): abort every streaming
        migration at the next step. True if any was in flight."""
        with self._lock:
            if not self._migrations:
                return False
            self._interrupt_next = True
            return True

    def set_network_delay(self, seconds: float) -> bool:
        """Chaos hook (``network_delay``): one-shot stall on the next
        page-stream tick (bounded — a slow interconnect, not a hang)."""
        with self._lock:
            self._delay_next_s = float(seconds)
            return True

    def _abort_migration(self, mig: FluidMigration, reason: str):
        mig.phase = "aborted"
        mig.chunks = []              # host buffers drop; nothing leaks
        mig.error = MigrationError(
            f"migration of {mig.agent_id!r} "
            f"({mig.src}->{mig.dst}) aborted: {reason}")
        self._migrations.pop(mig.agent_id, None)
        self._c_mig_aborted.inc()
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_abort, self._tr_fleet, mig.src, mig.dst)

    def _tick_migrations(self):
        if self._interrupt_next:
            for mig in list(self._migrations.values()):
                self._abort_migration(mig, "interrupted by fault injection")
            self._interrupt_next = False
            return
        if not self._migrations:
            return
        if self._delay_next_s > 0:
            time.sleep(min(self._delay_next_s, 0.25))
            self._delay_next_s = 0.0
        for mig in list(self._migrations.values()):
            if mig.agent_id in self._migrations:
                self._tick_one(mig)

    def _tick_one(self, mig: FluidMigration):
        src, dst = self.members[mig.src], self.members[mig.dst]
        if not src.alive or dst.state != M_ACTIVE:
            return self._abort_migration(mig, "an endpoint engine is gone")
        rid = src.backend.sessions.get(mig.agent_id)
        eng = src.backend.engine
        req = eng.reqs.get(rid) if rid is not None else None
        if req is None:
            return self._abort_migration(mig, "source session vanished")
        if req.state == "swapped":
            # KV pressure hibernated it mid-stream: the checksummed store
            # already holds the whole payload — finish via the slow path
            return self._handoff(mig, src, dst)
        if req.table is None:
            return self._abort_migration(mig, "source pages not resident")
        full = req.table.num_tokens // eng.cache.block_size
        hi = min(full, mig.pages_sent + self.fluid_pages_per_tick)
        if hi > mig.pages_sent:
            k, v = eng.cache.gather_range(req.table, mig.pages_sent, hi)
            mig.chunks.append((k, v))
            self._c_pages.inc(hi - mig.pages_sent)
            mig.pages_sent = hi
        remaining = req.table.num_pages - mig.pages_sent
        if remaining <= self.fluid_handoff_pages:
            self._handoff(mig, src, dst)

    def _handoff(self, mig: FluidMigration, src: FleetMember,
                 dst: FleetMember):
        """The bounded stop-the-session window: park, gather only the
        un-streamed tail, assemble, adopt on target, remap the external
        rid, release the source. Atomic under the fleet lock — no fault
        lands between adopt and release, so blocks cannot leak."""
        t0 = time.perf_counter()
        eng = src.backend.engine
        rid = src.backend.sessions[mig.agent_id]
        req = eng.reqs[rid]
        was_active = req.state == "active"
        if was_active:
            eng.park(rid)
        mid_turn = not req.done
        if req.state == "swapped":
            payload = src.backend.evict_session(mig.agent_id)
            tail_pages = 0
        else:
            tail_pages = req.table.num_pages - mig.pages_sent
            k_tail, v_tail = eng.cache.gather_range(
                req.table, mig.pages_sent, req.table.num_pages)
            if mig.chunks:
                k = np.concatenate(
                    [c[0] for c in mig.chunks] + [k_tail], axis=1)
                v = np.concatenate(
                    [c[1] for c in mig.chunks] + [v_tail], axis=1)
            else:
                k, v = k_tail, v_tail
            payload = src.backend.evict_session(
                mig.agent_id, pages=(k, v, req.table.num_tokens))
        if payload is None:
            return self._abort_migration(mig, "source export failed")
        # a mid-turn session resumes decoding on the target only if it
        # was actually RUNNING — one the middleware preempted stays
        # parked, so the middleware's own resume_turn (routed through the
        # remapped ext rid) stays the single resume
        new_rid = dst.backend.adopt_session(
            mig.agent_id, payload, resume=was_active and mid_turn)
        ext = self._rev.pop((src.idx, rid), None)
        if ext is not None:
            self._fwd[ext] = (dst.idx, new_rid)
            self._rev[(dst.idx, new_rid)] = ext
        self._home[mig.agent_id] = dst.idx
        self._migrations.pop(mig.agent_id, None)
        mig.phase = "done"
        mig.stall_s = time.perf_counter() - t0
        self.h_handoff.observe(mig.stall_s)
        self._c_mig_fluid.inc()
        rec = self.obs.recorder
        if rec.enabled:
            rec.complete(self._ev_handoff, self._tr_fleet, t0,
                         src.idx, dst.idx, tail_pages)

    # ------------------------------------------------------ rebalancing
    def _headroom_target(self, exclude: int,
                         pages: int) -> Optional[FleetMember]:
        """An active member with enough FREE DEVICE blocks to wake the
        moved session — "the fleet has headroom" means it can actually
        run there, not merely hold the bytes."""
        best, best_free = None, -1
        for mem in self._active_members():
            if mem.idx == exclude:
                continue
            free = mem.backend.engine.cache.allocator.num_free
            if free >= pages + 1 and free > best_free:
                best, best_free = mem, free
        return best

    def rebalance_for_admission(self, agent_id: str, prompt: str) -> bool:
        """Middleware hook (tried before hibernation degradation): make
        room for the waiter by moving load instead of parking it cold.
        New agents re-place to any engine that can admit; an agent stuck
        on a full home gets its home's largest *resident* idle session
        migrated to an engine with device headroom. False when the fleet
        has no headroom — the hibernate fallback still applies."""
        with self._lock:
            midx = self._home.get(agent_id)
            if midx is None or not self.members[midx].alive:
                return False
            mem = self.members[midx]
            if agent_id not in mem.backend.sessions:
                # no session bytes pin it here: just re-place the agent
                for other in self._active_members():
                    if (other.idx != midx
                            and other.backend.can_admit(agent_id, prompt)):
                        self._home[agent_id] = other.idx
                        self._c_rebalance.inc()
                        return True
                return False
            for victim, _rid, pages in mem.backend.idle_sessions():
                if victim == agent_id or victim in self._migrations:
                    continue
                if pages == 0:
                    continue    # already swapped: moving frees nothing
                target = self._headroom_target(exclude=midx, pages=pages)
                if target is None:
                    return False  # no headroom anywhere: hibernate path
                if self.migrate(victim, target.idx) is not None:
                    self._c_rebalance.inc()
                    return True
            return False

    # ----------------------------------------------- drain / scale up
    def drain(self, idx: int) -> dict:
        """Graceful scale-down: remove the member from placement, migrate
        idle sessions now and the rest as their turns finish (``step``
        keeps draining). The member leaves as "drained" once empty."""
        with self._lock:
            mem = self.members[idx]
            if mem.state != M_ACTIVE:
                raise ValueError(
                    f"engine {idx} is {mem.state}, not drainable")
            if not [m for m in self._active_members() if m.idx != idx]:
                raise ValueError("refusing to drain the last active engine")
            mem.state = M_DRAINING
            self._update_active_gauge()
            moved = self._drain_tick(mem)
            return {"idx": idx, "migrated_now": moved,
                    "complete": mem.state == M_DRAINED}

    def _drain_tick(self, mem: FleetMember) -> int:
        targets = self._active_members()
        if not targets:
            return 0
        moved = 0
        for agent_id, _rid, _pages in mem.backend.idle_sessions():
            if agent_id in self._migrations:
                continue
            dst = min(targets, key=self._load_key)
            if self.migrate(agent_id, dst.idx) is not None:
                moved += 1
        eng = mem.backend.engine
        if (not mem.backend.sessions and not eng.active
                and not eng._queue):
            mem.state = M_DRAINED
            self._c_drained.inc()
            rec = self.obs.recorder
            if rec.enabled:
                rec.instant(self._ev_drain, self._tr_fleet, mem.idx)
        return moved

    def add_engine(self, backend) -> int:
        """Live scale-up: the new member joins placement immediately (and,
        being empty, is the least-loaded target for the next admission or
        rebalance)."""
        with self._lock:
            mem = FleetMember(len(self.members), backend)
            self.members.append(mem)
            self._update_active_gauge()
            return mem.idx

    # --------------------------------------------- hibernation contract
    def hibernate_session(self, agent_id: str):
        with self._lock:
            midx = self._home.get(agent_id)
            if midx is not None and self.members[midx].alive \
                    and agent_id not in self._migrations:
                self.members[midx].backend.hibernate_session(agent_id)

    def wake_session(self, agent_id: str):
        with self._lock:
            midx = self._home.get(agent_id)
            if midx is not None and self.members[midx].alive:
                self.members[midx].backend.wake_session(agent_id)

    # ------------------------------------------------------ diagnostics
    def fleet_stats(self) -> dict:
        with self._lock:
            engines = {}
            for mem in self.members:
                eng = mem.backend.engine
                alloc = eng.cache.allocator
                engines[eng.name] = {
                    "state": mem.state,
                    "sessions": len(mem.backend.sessions),
                    "blocks_in_use": int(alloc.num_used),
                    "blocks_free": int(alloc.num_free),
                }
            m = self.obs.metrics

            def c(n):
                mc = m.get(n)
                return int(mc.value) if mc is not None else 0

            return {
                "engines": engines,
                "engines_active": len(self._active_members()),
                "migrations_in_flight": len(self._migrations),
                "migrations_sudden": c("fleet.migrations_sudden"),
                "migrations_fluid": c("fleet.migrations_fluid"),
                "migrations_aborted": c("fleet.migrations_aborted"),
                "pages_streamed": c("fleet.pages_streamed"),
                "engines_lost": c("fleet.engines_lost"),
                "engines_drained": c("fleet.engines_drained"),
                "member_rebuilds": c("fleet.member_rebuilds"),
                "sessions_failed_over": c("fleet.sessions_failed_over"),
                "rebalance_migrations": c("fleet.rebalance_migrations"),
            }
