"""Deterministic discrete-event simulator for agent-turn scheduling.

Reproduces the paper's evaluation (§VI Tables I–V) on a virtual clock:
arrivals, lane acquisition, hangs, the 5-second zombie reaper with
probabilistic recovery, AIMD rate-limit admission, RR quantum preemption,
and MLFQ boosting all run as events on a heap — seconds of simulated time
cost microseconds of wall clock and every run is seeded.

Semantics notes (documented deviations in DESIGN.md §8):
* Baselines: a hanging turn holds its lane for its full hang_duration, then
  fails — these are the paper's zombies (hold > 30 s while hanging).
* AgentRM reaper: scans every REAPER_PERIOD; a hang is detectable after
  DETECT_AFTER (heartbeat silence); each scan retries recovery with
  p=RECOVER_P; after MAX_RETRIES failures the turn is terminated and counted
  as a zombie. The paper's reported ~20 s zombie holds imply exactly this
  early-reap behaviour.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.scheduler.drf import DRFAccountant
from repro_torch.core.scheduler.policies import MLFQPolicy, Policy, make_policy
from repro_torch.core.scheduler.ratelimit import AdmissionController
from repro_torch.core.scheduler.task import (QueueClass, Turn, TurnState,
                                       ZOMBIE_THRESHOLD_S)

REAPER_PERIOD = 5.0
DETECT_AFTER = 10.0
RECOVER_P = 0.5
MAX_RETRIES = 2
STARVE_THRESHOLD = 60.0
LAG_THRESHOLD = 30.0


@dataclass
class SimConfig:
    lanes: int = 4
    seed: int = 0
    use_reaper: bool = False            # AgentRM only
    use_admission: bool = False         # AgentRM only
    token_rate: float = 6000.0
    token_burst: float = 24000.0


@dataclass
class Metrics:
    p95_ms: float
    p50_ms: float
    throughput_per_min: float
    zombies: int
    avg_hold_s: float
    lane_waste_s: float
    recovered: int
    starved: int
    lags_over_30s: int
    completed: int
    failed: int
    makespan_s: float

    def row(self) -> Dict[str, float]:
        return {
            "P95 (ms)": round(self.p95_ms),
            "Tput (/min)": round(self.throughput_per_min, 1),
            "Zombies": self.zombies,
            "Avg Hold (s)": round(self.avg_hold_s, 1),
            "Lane Waste (s)": round(self.lane_waste_s),
            "Recovered": self.recovered,
            "Starved": self.starved,
            "Lags>30s": self.lags_over_30s,
        }


class Simulator:
    def __init__(self, policy: Policy, cfg: SimConfig):
        self.policy = policy
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.now = 0.0
        self.events: list = []
        self._seq = itertools.count()
        self.free_lanes = cfg.lanes
        self.turns: List[Turn] = []
        self.running: Dict[int, dict] = {}   # tid -> {attempt, hang_since}
        self.admission = AdmissionController(cfg.token_rate, cfg.token_burst) \
            if cfg.use_admission else None
        self.drf = getattr(policy, "drf", None)

    # ----------------------------------------------------------- events
    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def add_turn(self, turn: Turn):
        self.turns.append(turn)
        self._push(turn.arrival, "arrive", turn)

    # ------------------------------------------------------------ core
    def run(self) -> Metrics:
        if self.cfg.use_reaper:
            self._push(REAPER_PERIOD, "reaper", None)
        self._push(1.0, "tick", None)
        horizon_guard = 24 * 3600.0
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if t > horizon_guard:
                break
            self.now = t
            getattr(self, f"_on_{kind}")(payload)
            self._dispatch()
        return self._metrics()

    def _work_left(self) -> bool:
        return bool(len(self.policy)) or bool(self.running)

    def _should_continue(self) -> bool:
        """Keep periodic events alive only while real work can still occur."""
        return self._work_left() or any(
            k not in ("tick", "reaper") for _, _, k, _ in self.events)

    # ------------------------------------------------------- handlers
    def _on_arrive(self, turn: Turn):
        turn.state = TurnState.QUEUED
        turn._enq_at = self.now
        self.policy.enqueue(turn, self.now)

    def _on_tick(self, _):
        self.policy.on_tick(self.now)
        if self.admission is not None:
            self.admission.aimd.on_clean()
        if self._should_continue():
            self._push(self.now + 1.0, "tick", None)

    def _start(self, turn: Turn):
        attempt = turn.retries
        turn.state = TurnState.RUNNING
        wait = self.now - getattr(turn, "_enq_at", turn.arrival)
        turn.queue_wait += wait
        if turn.start is None:
            turn.start = self.now
            turn.first_wait = self.now - turn.arrival
        self.free_lanes -= 1
        if self.drf is not None:
            self.drf.acquire(turn.agent_id, 1.0, turn.tokens)
        rec = {"attempt": attempt, "lane_at": self.now, "hang_since": None}
        self.running[turn.tid] = rec
        if turn.hangs and attempt == 0:
            turn.state = TurnState.HANGING
            rec["hang_since"] = self.now
            rec["turn"] = turn
            if self.admission is not None:
                self.admission.aimd.on_rate_limited()
            if not self.cfg.use_reaper:
                self._push(self.now + turn.hang_duration, "hang_fail", turn)
            return
        span = turn.remaining()
        if self.policy.preemptive and span > self.policy.quantum:
            self._push(self.now + self.policy.quantum, "quantum", turn)
        else:
            self._push(self.now + span, "finish", turn)

    def _release_lane(self, turn: Turn):
        self.free_lanes += 1
        if self.drf is not None:
            self.drf.release(turn.agent_id, 1.0, turn.tokens)
        self.running.pop(turn.tid, None)

    def _on_finish(self, turn: Turn):
        if turn.tid not in self.running or turn.state not in (
                TurnState.RUNNING, TurnState.HANGING):
            return
        turn.executed = turn.service
        turn.state = TurnState.DONE
        turn.end = self.now
        self._release_lane(turn)

    def _on_quantum(self, turn: Turn):
        if turn.tid not in self.running or turn.state != TurnState.RUNNING:
            return
        turn.executed += self.policy.quantum
        self._release_lane(turn)
        if turn.remaining() <= 1e-9:
            turn.state = TurnState.DONE
            turn.end = self.now
            return
        turn.state = TurnState.QUEUED
        turn._enq_at = self.now
        self.policy.requeue(turn, self.now)

    def _on_hang_fail(self, turn: Turn):
        """Baseline path: the stuck call finally returns after hang_duration
        (the turn completes, but held its lane the whole time — the paper's
        zombie: >30 s lane hold while hanging)."""
        if turn.tid not in self.running:
            return
        turn.hold = self.now - self.running[turn.tid]["lane_at"]
        turn.was_zombie = turn.hold > ZOMBIE_THRESHOLD_S
        turn.executed = turn.service
        turn.state = TurnState.DONE
        turn.end = self.now
        self._release_lane(turn)

    def _on_reaper(self, _):
        """AgentRM zombie reaper (every 5 s)."""
        for tid, rec in list(self.running.items()):
            turn = rec.get("turn")
            if turn is None or turn.state != TurnState.HANGING:
                continue
            hang_age = self.now - rec["hang_since"]
            if hang_age < DETECT_AFTER:
                continue
            if self.rng.random() < RECOVER_P:
                # probabilistic recovery: the retry proceeds as a fresh call
                turn.recovered = True
                turn.retries += 1
                turn.state = TurnState.RUNNING
                turn.hold = self.now - rec["lane_at"]
                self._push(self.now + turn.remaining(), "finish", turn)
            else:
                turn.retries += 1
                if turn.retries > MAX_RETRIES:
                    turn.hold = self.now - rec["lane_at"]
                    turn.was_zombie = True
                    turn.state = TurnState.FAILED
                    self._release_lane(turn)
        if self._should_continue():
            self._push(self.now + REAPER_PERIOD, "reaper", None)

    # ------------------------------------------------------- dispatch
    def _dispatch(self):
        while self.free_lanes > 0:
            nxt = self.policy.dequeue(self.now)
            if nxt is None:
                return
            if self.admission is not None and not self.admission.admit(
                    nxt.tokens, self.now):
                # defer: re-enqueue at head-ish and wake when budget refills
                nxt._enq_at = self.now
                self.policy.requeue(nxt, self.now)
                delay = max(0.5, self.admission.next_slot(nxt.tokens, self.now))
                self._push(self.now + delay, "tick", None)
                return
            self._start(nxt)

    # -------------------------------------------------------- metrics
    def _metrics(self) -> Metrics:
        done = [t for t in self.turns if t.state == TurnState.DONE]
        lat = sorted((t.response_time or 0.0) for t in done)

        def pct(p):
            if not lat:
                return 0.0
            i = min(len(lat) - 1, int(round(p * (len(lat) - 1))))
            return lat[i]

        zombies = [t for t in self.turns if t.was_zombie]
        waste = sum(t.hold for t in zombies)
        makespan = max((t.end or t.arrival) for t in self.turns) - min(
            t.arrival for t in self.turns) if self.turns else 0.0
        starved = sum(1 for t in self.turns
                      if t.queue_wait > STARVE_THRESHOLD and not t.boosted)
        return Metrics(
            p95_ms=pct(0.95) * 1000.0,
            p50_ms=pct(0.50) * 1000.0,
            throughput_per_min=len(done) / makespan * 60.0 if makespan else 0.0,
            zombies=len(zombies),
            avg_hold_s=(waste / len(zombies)) if zombies else 0.0,
            lane_waste_s=waste,
            recovered=sum(1 for t in self.turns if t.recovered),
            starved=starved,
            lags_over_30s=sum(1 for t in done
                              if (t.response_time or 0) > LAG_THRESHOLD),
            completed=len(done),
            failed=sum(1 for t in self.turns if t.state == TurnState.FAILED),
            makespan_s=makespan,
        )


def run_policy(policy_name: str, turns: List[Turn], *, lanes: int = 4,
               seed: int = 0) -> Metrics:
    """Convenience: run one policy over a scenario's turn list."""
    is_agentrm = policy_name.lower() in ("mlfq", "agentrm", "agentrm-mlfq")
    cfg = SimConfig(lanes=lanes, seed=seed, use_reaper=is_agentrm,
                    use_admission=is_agentrm)
    drf = DRFAccountant(lanes, cfg.token_rate) if is_agentrm else None
    policy = make_policy(policy_name, drf=drf)
    sim = Simulator(policy, cfg)
    for t in turns:
        sim.add_turn(t)
    return sim.run()
