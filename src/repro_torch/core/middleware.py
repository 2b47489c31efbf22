"""AgentRM middleware: the deployable artifact (paper §IV/§V).

Sits between the agent gateway and the model backend as a transparent layer:

    handle = agentrm.submit(agent_id, "user text")
    handle.result()        # response text

Two dispatch modes, chosen by the backend's contract:

  * **Fused (iteration-level)** — for a ``SteppableBackend`` (the paged
    engine). ONE dispatcher loop owns the inference iteration: it pulls
    turns from the MLFQ queues, admits them into the engine's decode batch
    (gated on free KV blocks *and* the token bucket — the engine's block
    reservation is token-budget-aware, see DESIGN.md §11), and drives
    ``backend.step()`` over the union of active sequences; the engine
    assembles each iteration decode-first and right-sizes the dispatch to
    its per-step token budget. MLFQ quanta are **decoded tokens**: a turn
    that has been serviced ``quantum_for(turn)`` tokens while others wait
    is *parked in place* (pages retained, swapped under pressure) and
    re-queued — demotion after the level's token allotment, boost
    unchanged. The reaper condemns a stalled turn and the dispatcher
    aborts it via ``abort_turn`` *between* steps, so batchmates never see
    a mid-step perturbation.
  * **Threaded (turn-level)** — the legacy path for plain ``ModelBackend``
    backends whose ``generate`` blocks per turn: semaphore lane pool, one
    thread per running turn, heartbeat watchdog. Kept for test fakes and
    engines that cannot interleave (it is also the serialized baseline the
    live scheduling benchmark measures the fused path against).

Shared across both: zombie reaper (heartbeat watchdog, probabilistic
recovery, kill-after-retries), token-bucket/AIMD admission, per-agent
Context Lifecycle Manager, resource monitor.
"""
from __future__ import annotations

import queue as _queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.context.manager import ContextLifecycleManager
from repro_torch.core.context.message import Message
from repro_torch.core.monitor import ResourceMonitor
from repro_torch.core.scheduler.drf import DRFAccountant
from repro_torch.obs import Observability
from repro_torch.core.scheduler.policies import (TOKEN_ALLOTMENTS, TOKEN_QUANTA,
                                           MLFQPolicy)
from repro_torch.core.scheduler.ratelimit import AdmissionController
from repro_torch.core.scheduler.task import QueueClass, Turn, TurnState


class ModelBackend:
    """Turn-level protocol. `generate` must call heartbeat() regularly and
    honour cancelled (a threading.Event) promptly."""

    def generate(self, agent_id: str, context: str, prompt: str,
                 heartbeat: Callable[[], None],
                 cancelled: threading.Event) -> str:
        raise NotImplementedError


@dataclass
class StepReport:
    """What one engine iteration did, in scheduler units."""
    serviced: Dict[int, int] = field(default_factory=dict)  # rid -> tokens
    finished: List[int] = field(default_factory=list)       # rids done
    failed: List[Tuple[int, BaseException]] = field(default_factory=list)
    # rids alive but not serviced this step (backpressured in the engine's
    # own admit queue) — still a heartbeat: waiting is not hanging
    waiting: List[int] = field(default_factory=list)


class SteppableBackend:
    """Iteration-level protocol: the fused dispatcher owns the loop and the
    backend exposes the engine's continuous-batching session surface.
    All methods are called from the dispatcher thread, except
    ``hibernate_session``/``wake_session`` which may arrive from user
    threads — implementations must lock the engine accordingly."""

    def begin_turn(self, agent_id: str, context: str, prompt: str) -> int:
        """Admit a new turn for this agent's session; returns rid."""
        raise NotImplementedError

    def session_busy(self, agent_id: str) -> bool:
        """True while the agent's session has another in-flight turn (a
        second turn must wait for it; the dispatcher rotates past it
        instead of head-of-line blocking the queue)."""
        return False

    def step(self) -> StepReport:
        """Advance every admitted sequence one iteration."""
        raise NotImplementedError

    def collect(self, rid: int) -> str:
        """Result text of a finished turn."""
        raise NotImplementedError

    def park_turn(self, rid: int):
        """Preempt in place; ``resume_turn`` continues bit-exactly."""
        raise NotImplementedError

    def resume_turn(self, rid: int):
        raise NotImplementedError

    def abort_turn(self, rid: int):
        """Cancel between steps (zombie reap); session survives if retained."""
        raise NotImplementedError

    def can_admit(self, agent_id: str, prompt: str) -> bool:
        """Admission gate: free batch slot, first-chunk KV blocks (what
        the engine's first dispatch can actually write — min of prompt,
        prefill chunk, and token budget), and no other in-flight turn on
        this agent's session."""
        raise NotImplementedError

    def victim_parkable(self, rid: int) -> bool:
        """May KV-pressure degradation pick this running turn as its
        park-and-hibernate victim? Backends return False for sequences
        that are already cold (parked/swapped/mid-migration) — parking
        those frees nothing and stalls admission for a retry cycle."""
        return True

    def rebalance_for_admission(self, agent_id: str, prompt: str) -> bool:
        """Fleet hook, tried BEFORE degradation when ``can_admit`` fails:
        migrate load to another engine (or re-place the agent) so the
        waiter fits without hibernating anyone. Returns True when
        placement changed and admission is worth re-checking; the
        single-engine default has nowhere to move load."""
        return False


@dataclass
class AgentRMConfig:
    lanes: int = 4
    detect_after_s: float = 10.0
    reaper_period_s: float = 1.0
    max_retries: int = 2
    recover_p: float = 0.5
    token_rate: float = 8000.0
    token_burst: float = 32000.0
    context_limit_tokens: int = 50_000
    physical_tokens: int = 100_000
    psi_inject: bool = True
    seed: int = 0
    # fused-dispatcher MLFQ parameters (token units; see policies.token_mlfq)
    quantum_tokens: tuple = TOKEN_QUANTA
    allotment_tokens: tuple = TOKEN_ALLOTMENTS
    boost_period_s: float = 25.0
    starve_after_s: float = 45.0
    # ---- fault handling (DESIGN.md §14) ------------------------------
    # transient step faults retry in place with exponential backoff + full
    # jitter; after `rebuild_after_failures` CONSECUTIVE failures (or one
    # fatal fault: watchdog timeout / engine crash) the dispatcher tears
    # down and rebuilds the engine via ``backend.rebuild()`` — journaled
    # sessions restore bit-exactly, live turns replay through admission
    step_backoff_s: float = 0.05
    step_backoff_max_s: float = 1.0
    rebuild_after_failures: int = 3
    # watchdog deadline for one ``backend.step()`` (seconds). None (the
    # default) calls the backend directly — zero overhead; set it and a
    # hung megastep becomes a typed ``StepTimeoutError`` instead of a
    # frozen dispatcher (the wedged executor thread is abandoned)
    step_deadline_s: Optional[float] = None
    # ---- overload autopilot (DESIGN.md §16) --------------------------
    # an ``repro_torch.serving.autopilot.AutopilotConfig`` (or True for the
    # defaults) arms the SLO feedback loop on the fused dispatcher:
    # live token-budget retuning + the brownout ladder down to typed
    # ``BackpressureError`` sheds. None (default) = static knobs.
    autopilot: Optional[object] = None


class TurnHandle:
    def __init__(self, turn: Turn):
        self.turn = turn
        self._done = threading.Event()
        self._result: Optional[str] = None
        self._error: Optional[BaseException] = None

    def _finish(self, result=None, error=None):
        self._result, self._error = result, error
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TimeoutError(f"turn {self.turn.tid} still pending")
        if self._error:
            raise self._error
        return self._result


class ZombieKilled(RuntimeError):
    pass


class TurnCancelled(ZombieKilled):
    """A turn aborted on the caller's initiative (``AgentRM.cancel``),
    e.g. a gateway-side turn timeout — engine-side the abort goes through
    the same between-steps ``abort_turn`` path as a reap, so the turn's
    KV blocks are released, never leaked."""


class _StepRunner:
    """Persistent executor thread for watchdogged ``backend.step()`` calls.

    The dispatcher hands the step closure to the worker and waits at most
    ``deadline`` seconds. On timeout the worker is ABANDONED together with
    its queues — a Python thread blocked inside XLA cannot be interrupted —
    and a fresh worker is spawned for the next step; if the wedged one ever
    unblocks, its result lands in an orphaned queue and is dropped, so a
    late step can never be double-applied."""

    def __init__(self):
        self._req: Optional[_queue.Queue] = None
        self._res: Optional[_queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    def _spawn(self):
        self._req, self._res = _queue.Queue(), _queue.Queue()
        self._thread = threading.Thread(
            target=self._work, args=(self._req, self._res), daemon=True)
        self._thread.start()

    @staticmethod
    def _work(req_q: _queue.Queue, res_q: _queue.Queue):
        while True:
            fn = req_q.get()
            if fn is None:
                return
            try:
                res_q.put((True, fn()))
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                res_q.put((False, e))

    def run(self, fn, deadline: float):
        if self._thread is None or not self._thread.is_alive():
            self._spawn()
        self._req.put(fn)
        try:
            ok, val = self._res.get(timeout=deadline)
        except _queue.Empty:
            self._req.put(None)       # exit marker, if it ever unblocks
            self._thread = None       # orphan the wedged worker + queues
            raise TimeoutError(
                f"backend step exceeded the {deadline}s watchdog deadline")
        if ok:
            return val
        raise val

    def stop(self):
        if self._thread is not None and self._req is not None:
            self._req.put(None)
            self._thread = None


class AgentRM:
    """The middleware resource manager."""

    def __init__(self, backend, cfg: Optional[AgentRMConfig] = None,
                 obs: Optional[Observability] = None):
        self.backend = backend
        self.cfg = cfg or AgentRMConfig()
        self.fused = isinstance(backend, SteppableBackend)
        self.rng = random.Random(self.cfg.seed)
        # observability (DESIGN.md §12): adopt the backend's engine context
        # when none is given, so the fused stack shares ONE registry, ring
        # and clock across engine + scheduler + monitor by default
        self.obs = obs or getattr(backend, "obs", None) or Observability()
        self.monitor = ResourceMonitor(lanes_total=self.cfg.lanes,
                                       metrics=self.obs.metrics)
        rec = self.obs.recorder
        self._tr_mlfq = [rec.track(f"Q{lvl}", group="mlfq")
                         for lvl in range(3)]
        self._ev_submitted = rec.name("sched.submitted", ("tid", "level"))
        self._ev_admitted = rec.name("sched.admitted",
                                     ("tid", "level", "wait_s"))
        self._ev_preempted = rec.name("sched.preempted",
                                      ("tid", "level", "served_tokens"))
        self._ev_demoted = rec.name("sched.demoted", ("tid", "level"))
        self._ev_boosted = rec.name("sched.boosted", ("tid",))
        self._ev_reaped = rec.name("sched.reaped", ("tid", "retries"))
        # the turn's engine session, at each begin_turn (resumed 0) and
        # resume_turn (1): joins the MLFQ's tids to the engine's rids
        self._ev_started = rec.name("sched.started",
                                    ("tid", "rid", "resumed"))
        # the fused dispatcher's pass, as spans on its own track: the locked
        # section before the step, the one after it, and the idle wait
        self._tr_disp = rec.track("dispatcher", group="sched")
        self._ev_pass = rec.name("sched.pass", ("running", "queued"))
        self._ev_charge = rec.name("sched.charge", ("serviced", "finished"))
        self._ev_wait = rec.name("sched.wait")
        # fault/recovery instrumentation (DESIGN.md §14): counters for every
        # recovery mechanism plus trace instants on a dedicated track, so a
        # chaos soak's Perfetto view shows faults next to scheduling
        self._tr_faults = rec.track("faults", group="sched")
        self._ev_rebuilt = rec.name("sched.engine_rebuilt", ("failures",))
        self._ev_degraded = rec.name("sched.kv_degraded",
                                     ("victim_tid", "for_tid"))
        self._ev_rebalanced = rec.name("sched.kv_rebalanced", ("for_tid",))
        self._ev_retry = rec.name("sched.step_retry", ("failures",))
        m = self.obs.metrics
        self._c_retries = m.counter("rm.step_retries")
        self._c_rebuilds = m.counter("rm.engine_rebuilds")
        self._c_degrade = m.counter("rm.kv_degradations")
        self._c_rebalance = m.counter("rm.kv_rebalances")
        self._c_429 = m.counter("rm.rate_limit_events")
        self._c_step_timeouts = m.counter("rm.step_timeouts")
        self._c_sheds = m.counter("rm.admissions_shed")
        self._c_preempt = m.counter("rm.preemptions")
        self._consec_failures = 0
        self._backoff = self.cfg.step_backoff_s
        self._step_runner: Optional[_StepRunner] = None
        self._cancelled_tids: set = set()   # cancelled while still queued
        self._errs = None                   # lazy: repro_torch.serving.errors
        self.drf = DRFAccountant(self.cfg.lanes, self.cfg.token_rate)
        if self.fused:
            self.policy = MLFQPolicy(
                drf=self.drf, quanta=self.cfg.quantum_tokens,
                allotments=self.cfg.allotment_tokens,
                boost_period=self.cfg.boost_period_s,
                starve_after=self.cfg.starve_after_s)
        else:
            self.policy = MLFQPolicy(drf=self.drf)
        if rec.enabled:
            # anti-starvation boosts happen inside the policy's tick; the
            # hook routes them onto the Q0 track
            self.policy.on_boost = lambda t: rec.instant(
                self._ev_boosted, self._tr_mlfq[0], t.tid)
        self.admission = AdmissionController(self.cfg.token_rate,
                                             self.cfg.token_burst)
        # overload autopilot (DESIGN.md §16): fused-mode only — it rides
        # the dispatcher pass. Function-level import: repro_torch.core must not
        # import repro_torch.serving at module load (backend.py imports this
        # module), and by construction time the cycle cannot bite.
        self.autopilot = None
        if self.fused and self.cfg.autopilot is not None:
            from repro_torch.serving.autopilot import (AutopilotConfig,
                                                 SLOAutopilot)
            ap_cfg = (AutopilotConfig() if self.cfg.autopilot is True
                      else self.cfg.autopilot)
            if ap_cfg.queue_high is None:
                ap_cfg.queue_high = 8 * self.cfg.lanes
            self.autopilot = SLOAutopilot(ap_cfg, obs=self.obs)
            self.autopilot.bind(backend,
                                hibernate=self._autopilot_hibernate,
                                rebalance=self._autopilot_rebalance,
                                aimd=self.admission.aimd)
        self.clm: Dict[str, ContextLifecycleManager] = {}
        self.handles: Dict[int, TurnHandle] = {}
        self._prompts: Dict[int, str] = {}
        self._running: Dict[int, dict] = {}   # tid -> rec (holds a lane/slot)
        self._parked: Dict[int, dict] = {}    # tid -> rec (fused: preempted)
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._lanes = threading.Semaphore(self.cfg.lanes)
        loop = self._fused_loop if self.fused else self._dispatch_loop
        self._dispatcher = threading.Thread(target=loop, daemon=True)
        self._reaper = threading.Thread(target=self._reaper_loop, daemon=True)
        self._dispatcher.start()
        self._reaper.start()

    # ------------------------------------------------------------ public
    def submit(self, agent_id: str, prompt: str,
               queue_class: QueueClass = QueueClass.INTERACTIVE,
               est_tokens: int = 800) -> TurnHandle:
        turn = Turn(agent_id=agent_id, arrival=time.monotonic(),
                    service=0.0, queue_class=queue_class, tokens=est_tokens)
        handle = TurnHandle(turn)
        ap = self.autopilot
        if ap is not None and ap.shedding \
                and ap.should_shed(len(self.policy)):
            # the brownout ladder's last rung (DESIGN.md §16): NEW
            # admissions are refused with a typed, finite retry hint
            # while the queue already holds enough to keep the engine
            # fed — nothing queued, running, or parked is touched, and
            # the trickle that sustains drain-at-capacity still lands
            from repro_torch.serving.errors import BackpressureError
            with self._lock:
                retry = ap.retry_after(
                    self.admission.next_slot(est_tokens, time.monotonic()))
                self._c_sheds.inc()
                self.handles[turn.tid] = handle
            turn.state = TurnState.FAILED
            handle._finish(error=BackpressureError(
                f"turn for {agent_id} shed by overload autopilot "
                f"(rung {ap.rung}); retry after {retry:.3f}s",
                retry_after_s=retry))
            return handle
        rec = self.obs.recorder
        with self._lock:
            self.handles[turn.tid] = handle
            self._prompts[turn.tid] = prompt
            turn._enq_at = time.monotonic()
            self.policy.enqueue(turn, time.monotonic())
            self.monitor.on_queue_depth(int(queue_class),
                                        len(self.policy))
            if rec.enabled:
                # trace clock is perf_counter (the recorder's domain), kept
                # separate from the scheduler's monotonic bookkeeping above
                turn._trace_enq = rec.now()
                lvl = self.policy.level_of(turn)
                rec.instant(self._ev_submitted, self._tr_mlfq[lvl],
                            turn.tid, lvl)
        self._wake.set()
        return handle

    def context_for(self, agent_id: str) -> ContextLifecycleManager:
        with self._lock:
            if agent_id not in self.clm:
                self.clm[agent_id] = ContextLifecycleManager(
                    limit_tokens=self.cfg.context_limit_tokens,
                    physical_tokens=self.cfg.physical_tokens)
            return self.clm[agent_id]

    def hibernate_agent(self, agent_id: str, path: Optional[str] = None):
        """CLM tier transition active -> hibernated: serialise the text-side
        session (CRIU-style JSON, if ``path`` given) and swap the agent's
        KV-cache pages to the host-RAM tier when the backend is paged
        (O(live pages); the dense extract_slot path copied O(max_len))."""
        if path is not None:
            self.context_for(agent_id).hibernate(path)
        hib = getattr(self.backend, "hibernate_session", None)
        if hib is not None:
            before = self._swap_sim_latency()
            hib(agent_id)
            self.context_for(agent_id).charge_swap_latency(
                self._swap_sim_latency() - before)

    def wake_agent(self, agent_id: str, path: Optional[str] = None):
        """Inverse tier transition: restore the CLM (if ``path`` given) and
        rebind the agent's swapped KV pages to fresh device blocks."""
        if path is not None:
            with self._lock:
                self.clm[agent_id] = ContextLifecycleManager.restore(
                    path, limit_tokens=self.cfg.context_limit_tokens,
                    physical_tokens=self.cfg.physical_tokens)
        wake = getattr(self.backend, "wake_session", None)
        if wake is not None:
            before = self._swap_sim_latency()
            wake(agent_id)
            self.context_for(agent_id).charge_swap_latency(
                self._swap_sim_latency() - before)

    def _swap_sim_latency(self) -> float:
        """Sum the simulated transfer-latency ledgers of every live
        engine's swap store (fleet/chaos wrappers included). Charged as
        a before/after delta around hibernate/wake so swap traffic —
        including disk-tier spills and read-backs — lands in the acting
        agent's CLM cost model."""
        from repro_torch.serving.autopilot import _live_engines
        total = 0.0
        for eng in _live_engines(self.backend):
            store = getattr(getattr(eng, "swap", None), "store", None)
            if store is not None:
                total += float(getattr(store, "sim_latency_s", 0.0))
        return total

    def cancel(self, tid: int, reason: str = "cancelled by caller") -> bool:
        """Abort a turn from outside the dispatcher (e.g. a gateway-side
        turn timeout). A RUNNING turn is condemned and the dispatcher
        aborts it engine-side between steps — its KV blocks and page-table
        entries are released through the same ``abort_turn`` path as a
        reap, never leaked. Parked or still-queued turns fail immediately.
        The handle resolves to ``TurnCancelled``. Returns False when the
        turn is unknown or already finished."""
        with self._lock:
            h = self.handles.get(tid)
            if h is None or h._done.is_set():
                return False
            err = TurnCancelled(f"turn {tid} {reason}")
            rec = self._running.get(tid)
            if rec is not None:
                rec["cancel_error"] = err
                rec["cancelled"].set()
                self._wake.set()
                return True
            rec = self._parked.pop(tid, None)
            if rec is not None:
                try:
                    self.backend.abort_turn(rec["rid"])
                except BaseException:  # noqa: BLE001 — still fail the handle
                    pass
                rec["turn"].state = TurnState.FAILED
                h._finish(error=err)
                return True
            # still queued: the dispatcher discards it at dequeue
            self._cancelled_tids.add(tid)
            h._finish(error=err)
            return True

    def report_rate_limited(self, n: int = 1):
        """Feed upstream 429s into the AIMD admission controller: the
        admission budget multiplier halves per event (floored) and
        recovers additively on clean admissions. Real gateway adapters and
        the chaos injector's simulated 429 bursts share this hook."""
        n = max(1, int(n))
        with self._lock:
            for _ in range(n):
                self.admission.aimd.on_rate_limited()
            self._c_429.inc(n)
            self.obs.metrics.gauge("rm.aimd_multiplier").set(
                self.admission.aimd.multiplier)

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        if self._step_runner is not None:
            self._step_runner.stop()

    # ------------------------------------------------ shared helpers
    def _build_context(self, agent_id: str) -> str:
        clm = self.context_for(agent_id)
        parts = [e.text for e in clm.window()]
        if self.cfg.psi_inject:
            parts.append(clm.psi_message())
        return "\n".join(parts)

    def _commit_turn(self, turn: Turn, out: str):
        """Record both sides of the turn in the agent's CLM (caller holds
        the lock and has verified the turn was not condemned)."""
        clm = self.context_for(turn.agent_id)
        clm.add(Message(role="user", text=self._prompts[turn.tid],
                        turn=clm._clock + 1))
        clm.add(Message(role="assistant", text=out, turn=clm._clock + 1))
        self.monitor.on_context(turn.agent_id, clm.window_tokens, clm.limit)

    # ===================================================== fused dispatch
    def _fused_loop(self):
        """The tentpole: scheduler fused into the inference iteration.
        Each pass = reap condemned turns -> preempt over-quantum turns ->
        admit from MLFQ -> one ``backend.step()`` -> charge token service.
        The engine step runs OUTSIDE the middleware lock so ``submit`` and
        CLM calls never wait on XLA."""
        be = self.backend
        # deferred import: repro_torch.core must not import repro_torch.serving at
        # module load (backend.py imports this module) — by the time the
        # dispatcher thread runs, the cycle cannot bite
        from repro_torch.serving import errors as engine_errors
        self._errs = engine_errors
        trec = self.obs.recorder
        while not self._stop.is_set():
            # the pass's spans: lock acquisition included; with the
            # recorder off no clock is read for them
            tracing = trec.enabled
            tp = trec.now() if tracing else 0.0
            now = time.monotonic()
            with self._lock:
                self.policy.on_tick(now)
                self._reap_condemned(be)
                self._preempt_over_quantum(be, now)
                self._admit_from_queue(be, now)
                if self.autopilot is not None:
                    # SLO feedback (DESIGN.md §16): read windowed p95s +
                    # queue depth, move the brownout ladder at most one
                    # rung, apply at most one bounded mechanism action
                    self.autopilot.on_pass(now, len(self.policy))
                idle = not self._running
                if tracing:
                    trec.complete(self._ev_pass, self._tr_disp, tp,
                                 len(self._running), len(self.policy))
            if idle:
                tw = trec.now() if tracing else 0.0
                self._wake.wait(timeout=0.02)
                self._wake.clear()
                if tracing:
                    trec.complete(self._ev_wait, self._tr_disp, tw)
                continue
            try:
                report = self._checked_step(be)
            except BaseException as e:  # noqa: BLE001 — step failed
                self._on_step_failure(be, e)
                continue
            self._consec_failures = 0
            self._backoff = self.cfg.step_backoff_s
            tc = trec.now() if tracing else 0.0
            now = time.monotonic()
            with self._lock:
                rid_to_tid = {r["rid"]: t for t, r in self._running.items()}
                for rid in report.waiting:
                    tid = rid_to_tid.get(rid)
                    if tid is not None:
                        # backpressured inside the engine, not hanging —
                        # don't let the reaper condemn a queued turn
                        self._running[tid]["last_beat"] = now
                for rid, ntok in report.serviced.items():
                    tid = rid_to_tid.get(rid)
                    if tid is None:
                        continue
                    rec = self._running[tid]
                    rec["last_beat"] = now
                    rec["served_run"] += ntok
                    rec["turn"].executed += ntok
                for rid, err in report.failed:
                    tid = rid_to_tid.get(rid)
                    if tid is not None:
                        self._finish_fused(tid, error=err)
                for rid in report.finished:
                    tid = rid_to_tid.get(rid)
                    if tid is None:
                        continue
                    rec = self._running[tid]
                    if rec["cancelled"].is_set():
                        self._finish_fused(
                            tid, error=rec.get("cancel_error")
                            or ZombieKilled(f"turn {tid} reaped"))
                        continue
                    try:
                        out = be.collect(rid)
                    except BaseException as e:  # noqa: BLE001
                        self._finish_fused(tid, error=e)
                        continue
                    self._finish_fused(tid, result=out)
                if tracing:
                    trec.complete(self._ev_charge, self._tr_disp, tc,
                                 len(report.serviced), len(report.finished))

    def _checked_step(self, be):
        """One ``backend.step()``, optionally under the watchdog deadline.
        ``step_deadline_s=None`` (the default) is a direct call — zero
        overhead; with a deadline the step runs on the persistent executor
        and a hang surfaces as a typed ``StepTimeoutError`` (fatal tier:
        the engine is suspect, recovery tears it down)."""
        dl = self.cfg.step_deadline_s
        if dl is None:
            return be.step()
        if self._step_runner is None:
            self._step_runner = _StepRunner()
        try:
            return self._step_runner.run(be.step, dl)
        except TimeoutError as e:
            self._c_step_timeouts.inc()
            raise self._errs.StepTimeoutError(str(e)) from e

    def _on_step_failure(self, be, e: BaseException):
        """Classify a failed step by error class (DESIGN.md §14):
        transient -> retry the SAME step in place with exponential backoff
        + full jitter (turns stay admitted, nothing aborted); transient
        beyond the consecutive-failure budget, or fatal (watchdog timeout /
        crash / unclassified) -> teardown + rebuild."""
        errs = self._errs
        self._consec_failures += 1
        if (errs.is_transient(e)
                and self._consec_failures < self.cfg.rebuild_after_failures):
            self._c_retries.inc()
            if self.obs.tracing:
                self.obs.recorder.instant(self._ev_retry, self._tr_faults,
                                          self._consec_failures)
            delay = self._backoff * (1.0 + self.rng.random())
            self._backoff = min(self._backoff * 2.0,
                                self.cfg.step_backoff_max_s)
            self._stop.wait(delay)      # interruptible backoff
            return
        self._recover_or_fail(be, e)

    def _recover_or_fail(self, be, e: BaseException):
        """The K-consecutive-failures escalation: tear the engine down and
        rebuild it from the session journal when the backend supports it
        (``rebuild()`` True). Every journaled session resumes bit-exactly;
        live turns — running or parked, at most the in-flight ones — are
        requeued and replay from scratch through normal admission against
        the restored session state. A backend without recovery gets the
        pre-chaos behaviour: abort every running turn engine-side (blocks
        released) and fail its handle with the typed error."""
        errs = self._errs
        failures = self._consec_failures
        self._consec_failures = 0
        self._backoff = self.cfg.step_backoff_s
        rebuild = getattr(be, "rebuild", None)
        rebuilt = False
        if rebuild is not None:
            try:
                rebuilt = bool(rebuild())
            except BaseException:  # noqa: BLE001 — fall back to fail-all
                rebuilt = False
        now = time.monotonic()
        with self._lock:
            if not rebuilt:
                err = e if isinstance(e, errs.EngineError) \
                    else errs.EngineCrashError(str(e))
                for tid, rec in list(self._running.items()):
                    # best-effort engine-side cleanup so slots/blocks are
                    # not leaked and future turns can still admit
                    try:
                        be.abort_turn(rec["rid"])
                    except BaseException:  # noqa: BLE001
                        pass
                    self._finish_fused(tid, error=err)
                # parked turns hold rids into the same suspect engine:
                # fail them too (lane/DRF were released at park), or
                # they would resume into stale rid space — or hang
                # forever if the engine never comes back
                for tid, rec in list(self._parked.items()):
                    del self._parked[tid]
                    try:
                        be.abort_turn(rec["rid"])
                    except BaseException:  # noqa: BLE001
                        pass
                    rec["turn"].state = TurnState.FAILED
                    self.handles[tid]._finish(error=err)
                return
            self._c_rebuilds.inc()
            if self.obs.tracing:
                self.obs.recorder.instant(self._ev_rebuilt, self._tr_faults,
                                          failures)
            for tid, rec in list(self._running.items()):
                del self._running[tid]
                self.monitor.on_lane(-1)
                self.drf.release(rec["turn"].agent_id, 1.0,
                                 rec["turn"].tokens)
                self._replay_after_rebuild(rec, now)
            for tid, rec in list(self._parked.items()):
                del self._parked[tid]          # lane/DRF released at park
                self._replay_after_rebuild(rec, now)

    def _replay_after_rebuild(self, rec: dict, now: float):
        """Requeue one live turn after an engine rebuild. Its old rid died
        with the old engine; admission will begin a fresh turn against the
        journal-restored session. A turn the reaper had already condemned
        stays dead — rebuilds must not resurrect zombies."""
        turn: Turn = rec["turn"]
        if rec["cancelled"].is_set():
            turn.state = TurnState.FAILED
            self.handles[turn.tid]._finish(
                error=rec.get("cancel_error") or ZombieKilled(
                    f"turn {turn.tid} reaped"))
            return
        rec["served_run"] = 0
        turn.state = TurnState.QUEUED
        turn._enq_at = now
        self.policy.requeue(turn, now)

    def _reap_condemned(self, be):
        """Apply the reaper's verdicts between steps: ``abort_turn`` drops
        the sequence from the batch (retained sessions survive parked)
        without touching its batchmates."""
        for tid, rec in list(self._running.items()):
            if rec["cancelled"].is_set():
                try:
                    be.abort_turn(rec["rid"])
                except BaseException:  # noqa: BLE001 — still fail the handle
                    pass
                if self.obs.tracing:
                    self.obs.recorder.instant(
                        self._ev_reaped,
                        self._tr_mlfq[self.policy.level_of(rec["turn"])],
                        tid, rec["turn"].retries)
                self._finish_fused(
                    tid, error=rec.get("cancel_error") or ZombieKilled(
                        f"turn {tid} reaped after "
                        f"{rec['turn'].retries} retries"))

    def _preempt_over_quantum(self, be, now: float):
        """Token-quantum preemption (work-conserving: only when someone is
        actually waiting). The sequence is parked in place — pages stay,
        requeue applies MLFQ demotion if its cumulative service overran the
        level's allotment."""
        if not len(self.policy) or len(self._running) < self.cfg.lanes:
            # nobody waiting, or a free slot could serve the waiter without
            # preempting anyone — parking would only cost page churn
            return
        for tid, rec in list(self._running.items()):
            turn: Turn = rec["turn"]
            if rec["served_run"] < self.policy.quantum_for(turn):
                continue
            try:
                be.park_turn(rec["rid"])
            except BaseException:  # noqa: BLE001 — leave it running
                continue
            del self._running[tid]
            served = rec["served_run"]
            rec["served_run"] = 0
            self._parked[tid] = rec
            self._c_preempt.inc()
            self.monitor.on_lane(-1)
            self.drf.release(turn.agent_id, 1.0, turn.tokens)
            turn.state = TurnState.QUEUED
            turn._enq_at = now
            lvl_before = self.policy.level_of(turn)
            self.policy.requeue(turn, now)
            if self.obs.tracing:
                trec = self.obs.recorder
                lvl_after = self.policy.level_of(turn)
                trec.instant(self._ev_preempted, self._tr_mlfq[lvl_before],
                             tid, lvl_before, served)
                if lvl_after != lvl_before:
                    trec.instant(self._ev_demoted, self._tr_mlfq[lvl_after],
                                 tid, lvl_after)
                turn._trace_enq = trec.now()

    def _requeue_waiting(self, turn: Turn, now: float):
        """Re-queue a turn that could not be admitted — accrue this queued
        episode into the cumulative starvation clock first, or the boost
        would re-age an admission-blocked turn to zero every pass."""
        turn.queue_wait += now - getattr(turn, "_enq_at", now)
        turn._enq_at = now
        lvl_before = self.policy.level_of(turn)
        self.policy.requeue(turn, now)
        if self.obs.tracing and self.policy.level_of(turn) != lvl_before:
            lvl = self.policy.level_of(turn)
            self.obs.recorder.instant(self._ev_demoted, self._tr_mlfq[lvl],
                                      turn.tid, lvl)

    def _admit_from_queue(self, be, now: float):
        """Pull turns from MLFQ while the engine has capacity; gate on the
        AIMD token bucket and on free KV blocks (head-of-line: a turn the
        engine can't hold yet blocks its queue position). A turn whose
        *session* is busy (its previous turn still in flight, possibly
        parked behind it in these very queues) is held ASIDE for the rest
        of the scan and only requeued afterwards. Holding it aside — not
        requeueing it mid-scan — is load-bearing: a busy turn requeued to
        Q0 would keep the dequeue scan pinned there, shadowing a demoted
        parked turn in Q1 of the *same agent* forever (the successor can't
        run until the parked turn finishes; the parked turn is never
        reached because the successor refills Q0 every rotation). That
        priority inversion stalled admission until the starvation boost —
        a 45-second dead batch under multi-turn traffic."""
        deferred: list = []
        while len(self._running) < self.cfg.lanes:
            nxt = self.policy.dequeue(now)
            if nxt is None:
                break
            if nxt.tid in self._cancelled_tids:
                self._cancelled_tids.discard(nxt.tid)
                continue                    # cancelled while queued: drop
            prompt = self._prompts[nxt.tid]
            resuming = nxt.tid in self._parked
            if not resuming:
                if be.session_busy(nxt.agent_id):
                    deferred.append(nxt)    # out of the queue for this scan
                    continue
                # a resumed turn already paid admission; only new turns are
                # gated on engine blocks and the AIMD token bucket
                if not be.can_admit(nxt.agent_id, prompt):
                    # under pressure, prefer MOVING load over degrading it
                    # (§15): a fleet backend migrates a cold session to
                    # the least-loaded engine (or re-places the agent)
                    # when the fleet has headroom; only when it doesn't —
                    # or on a single engine — fall back to parking the
                    # MLFQ-lowest running victim so its pages go cold and
                    # reclaimable instead of head-of-line stalling
                    # admission on a full pool
                    if self._rebalance_for_admission(be, nxt, prompt):
                        pass            # placement changed; re-check below
                    elif not self._degrade_for_blocks(be, nxt, now):
                        self._requeue_waiting(nxt, now)
                        break
                    if not be.can_admit(nxt.agent_id, prompt):
                        self._requeue_waiting(nxt, now)
                        break
                if not self.admission.admit(nxt.tokens, now):
                    self._requeue_waiting(nxt, now)
                    break
                # a clean admission is the AIMD controller's additive-
                # recovery signal (mirrors on_rate_limited's decrease)
                self.admission.aimd.on_clean()
            if resuming:
                rec = self._parked.pop(nxt.tid)
                try:
                    be.resume_turn(rec["rid"])
                except BaseException as e:  # noqa: BLE001
                    try:
                        # release the engine-side turn too, or session_busy
                        # would stay True forever for this agent
                        be.abort_turn(rec["rid"])
                    except BaseException:  # noqa: BLE001
                        pass
                    self.handles[nxt.tid]._finish(error=e)
                    continue
                rec["last_beat"] = now
            else:
                try:
                    rid = be.begin_turn(nxt.agent_id,
                                        self._build_context(nxt.agent_id),
                                        prompt)
                except BaseException as e:  # noqa: BLE001
                    self.handles[nxt.tid]._finish(error=e)
                    continue
                rec = {"turn": nxt, "rid": rid, "last_beat": now,
                       "served_run": 0, "cancelled": threading.Event()}
            self._running[nxt.tid] = rec
            self.monitor.on_lane(+1)
            self.drf.acquire(nxt.agent_id, 1.0, nxt.tokens)
            nxt.queue_wait += now - getattr(nxt, "_enq_at", now)
            if self.obs.tracing:
                trec = self.obs.recorder
                lvl = self.policy.level_of(nxt)
                wait = trec.now() - getattr(nxt, "_trace_enq", trec.now())
                trec.instant(self._ev_admitted, self._tr_mlfq[lvl],
                             nxt.tid, lvl, wait)
                trec.instant(self._ev_started, self._tr_mlfq[lvl], nxt.tid,
                             rec["rid"], float(resuming))
            nxt.state = TurnState.RUNNING
            nxt.start = nxt.start or now
            if nxt.first_wait is None:
                nxt.first_wait = now - nxt.arrival
            self.monitor.on_queue_depth(int(nxt.queue_class),
                                        len(self.policy))
        for t in deferred:
            self._requeue_waiting(t, now)

    # ------------------------------------------- autopilot mechanisms
    def _peek_queued(self) -> Optional[Turn]:
        """Head-of-queue waiter (highest-level first), skipping turns
        cancelled while queued. Caller holds the lock."""
        for q in self.policy.queues:
            for t in q:
                if t.tid not in self._cancelled_tids:
                    return t
        return None

    def _autopilot_hibernate(self) -> bool:
        """Brownout rung 2: cool ONE session so its KV pages become
        reclaimable. Prefers a truly idle resident session (turn done,
        parked — hibernating it swaps its pages out without touching any
        live turn); only when none exists does it park the MLFQ-lowest
        RUNNING victim, and only if someone is actually waiting (the
        same eligibility guards as KV-pressure degradation, so a parked
        turn can never be starved — it re-queues and rides the boost).
        Caller holds the lock."""
        be = self.backend
        hib = getattr(be, "hibernate_session", None)
        # hibernation reclaims KV blocks — if no live engine is actually
        # short on blocks (>25% free everywhere), cooling a session frees
        # capacity nobody is waiting for, and the gather runs on the
        # dispatcher thread stealing step time from the drain
        from repro_torch.serving.autopilot import _live_engines
        pressured = False
        for eng in _live_engines(be):
            alloc = getattr(getattr(eng, "cache", None), "allocator", None)
            if alloc is not None and alloc.num_blocks > 1 \
                    and alloc.num_free < 0.25 * (alloc.num_blocks - 1):
                pressured = True
                break
        if not pressured:
            return False
        # never cool a session whose next turn is already queued: it
        # would be woken (full swap-in) the moment that turn schedules,
        # so the hibernate frees nothing and the round trip is pure
        # thrash — under sustained overload that wake churn alone can
        # eat the throughput the shed rung just protected
        queued_agents = {t.agent_id for q in self.policy.queues for t in q}
        cands: List[str] = []
        idle = getattr(be, "idle_sessions", None)
        if idle is not None:
            try:
                cands = [a for a, _rid, pages in idle()
                         if pages > 0 and a not in queued_agents]
            except BaseException:  # noqa: BLE001 — best-effort
                cands = []
        else:
            for mem in getattr(be, "members", None) or []:
                if not getattr(mem, "alive", True):
                    continue
                try:
                    cands.extend(
                        a for a, _rid, pages in mem.backend.idle_sessions()
                        if pages > 0 and a not in queued_agents)
                except BaseException:  # noqa: BLE001
                    continue
        if hib is not None:
            for agent_id in cands:
                try:
                    hib(agent_id)
                    return True
                except BaseException:  # noqa: BLE001 — try the next one
                    continue
        head = self._peek_queued()
        if head is None:
            return False
        # the running-victim fallback exists to free BLOCKS for a waiter
        # that cannot admit; if the head waiter would admit fine, lanes —
        # not KV — are the bottleneck and parking a decoding turn would
        # only spike its ITL without unblocking anyone
        can = getattr(be, "can_admit", None)
        try:
            if can is not None and can(head.agent_id,
                                       self._prompts.get(head.tid, "")):
                return False
        except BaseException:  # noqa: BLE001 — fall through to degrade
            pass
        return self._degrade_for_blocks(be, head, time.monotonic())

    def _autopilot_rebalance(self) -> bool:
        """Brownout rung 3: proactive fleet rebalance for the head-of-
        queue waiter (the reactive path only fires after ``can_admit``
        already failed). Caller holds the lock."""
        head = self._peek_queued()
        if head is None:
            return False
        return self._rebalance_for_admission(
            self.backend, head, self._prompts.get(head.tid, ""))

    def _rebalance_for_admission(self, be, nxt: Turn, prompt: str) -> bool:
        """Try the backend's fleet rebalance hook (migrate-to-least-loaded,
        §15) before degrading anyone. Best-effort: a backend without the
        hook, or an exception inside it, just means no rebalance."""
        hook = getattr(be, "rebalance_for_admission", None)
        if hook is None:
            return False
        try:
            moved = bool(hook(nxt.agent_id, prompt))
        except BaseException:  # noqa: BLE001 — degrade path still works
            return False
        if moved:
            self._c_rebalance.inc()
            if self.obs.tracing:
                self.obs.recorder.instant(self._ev_rebalanced,
                                          self._tr_faults, nxt.tid)
        return moved

    def _degrade_for_blocks(self, be, nxt: Turn, now: float) -> bool:
        """Hibernate the MLFQ-lowest running victim so its pages become
        reclaimable cold state (park -> swap-under-pressure), freeing its
        decode slot for the waiter. Eligibility guards against thrash and
        priority inversion: the victim's level must be strictly below the
        waiter's, or equal with at least one token of service this run —
        so an admitted turn always decodes before it can itself be
        displaced by an equal-priority waiter, and every park/admit cycle
        makes progress. Victims the backend reports as not parkable
        (already hibernated, resume still queued, or mid-migration) are
        skipped — parking one frees nothing and the failed park would
        stall admission for a full retry cycle. Returns True when a
        victim was parked."""
        wait_lvl = self.policy.level_of(nxt)
        parkable = getattr(be, "victim_parkable", None)
        victim_tid, victim_lvl = None, -1
        for tid, rec in self._running.items():
            if rec["cancelled"].is_set():
                continue
            if parkable is not None and not parkable(rec["rid"]):
                continue
            lvl = self.policy.level_of(rec["turn"])
            eligible = lvl > wait_lvl or (lvl == wait_lvl
                                          and rec["served_run"] > 0)
            if eligible and lvl > victim_lvl:
                victim_tid, victim_lvl = tid, lvl
        if victim_tid is None:
            return False
        rec = self._running[victim_tid]
        try:
            be.park_turn(rec["rid"])
        except BaseException:  # noqa: BLE001 — not parkable right now
            return False
        del self._running[victim_tid]
        rec["served_run"] = 0
        self._parked[victim_tid] = rec
        self.monitor.on_lane(-1)
        turn: Turn = rec["turn"]
        self.drf.release(turn.agent_id, 1.0, turn.tokens)
        turn.state = TurnState.QUEUED
        turn._enq_at = now
        self.policy.requeue(turn, now)
        self._c_degrade.inc()
        if self.obs.tracing:
            self.obs.recorder.instant(self._ev_degraded, self._tr_faults,
                                      victim_tid, nxt.tid)
        return True

    def _finish_fused(self, tid: int, result=None, error=None):
        """Caller holds the lock."""
        rec = self._running.pop(tid, None)
        if rec is None:
            return
        turn: Turn = rec["turn"]
        self.monitor.on_lane(-1)
        self.drf.release(turn.agent_id, 1.0, turn.tokens)
        if error is None:
            self._commit_turn(turn, result)
            turn.state = TurnState.DONE
            turn.end = time.monotonic()
        else:
            turn.state = TurnState.FAILED
        self.handles[tid]._finish(result=result, error=error)

    # ================================================== threaded dispatch
    def _dispatch_loop(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            while True:
                with self._lock:
                    self.policy.on_tick(time.monotonic())
                    nxt = self.policy.dequeue(time.monotonic())
                    if nxt is None:
                        break
                    if not self.admission.admit(nxt.tokens, time.monotonic()):
                        nxt._enq_at = time.monotonic()
                        self.policy.requeue(nxt, time.monotonic())
                        break
                if not self._lanes.acquire(timeout=0.2):
                    with self._lock:
                        self.policy.requeue(nxt, time.monotonic())
                    break
                threading.Thread(target=self._run_turn, args=(nxt,),
                                 daemon=True).start()

    def _run_turn(self, turn: Turn):
        handle = self.handles[turn.tid]
        cancelled = threading.Event()
        rec = {"turn": turn, "last_beat": time.monotonic(),
               "cancelled": cancelled, "lane_at": time.monotonic()}
        with self._lock:
            self._running[turn.tid] = rec
            self.monitor.on_lane(+1)
            self.drf.acquire(turn.agent_id, 1.0, turn.tokens)
        turn.state = TurnState.RUNNING
        turn.start = turn.start or time.monotonic()

        prompt = self._prompts[turn.tid]
        context = self._build_context(turn.agent_id)

        def heartbeat():
            rec["last_beat"] = time.monotonic()

        try:
            out = self.backend.generate(turn.agent_id, context, prompt,
                                        heartbeat, cancelled)
            # a backend that returns *after* the reaper decided to kill it
            # must not record its output — check-and-record atomically so the
            # reaper can't set `cancelled` between the check and the CLM write
            with self._lock:
                if cancelled.is_set():
                    raise ZombieKilled(f"turn {turn.tid} reaped")
                self._commit_turn(turn, out)
            turn.state = TurnState.DONE
            turn.end = time.monotonic()
            handle._finish(result=out)
        except BaseException as e:  # noqa: BLE001 — reap/kill path
            turn.state = TurnState.FAILED
            handle._finish(error=e)
        finally:
            with self._lock:
                self._running.pop(turn.tid, None)
                self.monitor.on_lane(-1)
                self.drf.release(turn.agent_id, 1.0, turn.tokens)
            self._lanes.release()
            self._wake.set()

    # ====================================================== zombie reaper
    def _reaper_loop(self):
        """Shared by both modes: heartbeat-silence detection, probabilistic
        recovery, condemnation after max_retries. In fused mode the verdict
        is a flag — the dispatcher applies it via ``abort_turn`` between
        engine steps; in threaded mode the worker thread observes it."""
        while not self._stop.is_set():
            # interruptible sleep: shutdown() must not wait out a full
            # reaper period before the thread notices _stop
            if self._stop.wait(self.cfg.reaper_period_s):
                return
            now = time.monotonic()
            with self._lock:
                # a record whose cancelled flag is already set has been
                # condemned — re-reaping it would double-count zombies
                hanging = [r for r in self._running.values()
                           if now - r["last_beat"] > self.cfg.detect_after_s
                           and not r["cancelled"].is_set()]
            for rec in hanging:
                # the kill decision must happen under the same lock as the
                # worker's check-and-record, or a backend returning right now
                # could still commit its output after we condemn it
                with self._lock:
                    turn: Turn = rec["turn"]
                    turn.retries += 1
                    if (turn.retries <= self.cfg.max_retries
                            and self.rng.random() < self.cfg.recover_p):
                        # probabilistic recovery: nudge the backend via
                        # heartbeat reset; transient stalls resume on their own
                        rec["last_beat"] = now
                        turn.recovered = True
                        self.monitor.on_reap(recovered=True)
                    elif turn.retries > self.cfg.max_retries:
                        turn.was_zombie = True
                        rec["cancelled"].set()
                        self.monitor.on_reap(recovered=False)
