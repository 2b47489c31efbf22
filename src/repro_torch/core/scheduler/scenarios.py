"""The paper's five scheduling scenarios (§VI.A), seeded + regenerable.

Turn counts / agent counts / hang rates match the paper exactly; service-time
and hang-duration distributions are not given in the paper, so they are
calibrated (DESIGN.md §8.1) to land in the reported ranges:

  normal   27 turns,  3 agents,  5% hang
  high     280 turns, 10 agents, 10% hang
  burst    30 turns in a 3 s window, 8% hang
  faulty   63 turns,  5 agents, 30% hang
  cascade  149 turns, 5 agents, hang rate oscillating 5–40% over 10 min
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, List

from repro_torch.core.scheduler.task import QueueClass, Turn


@dataclass(frozen=True)
class Scenario:
    name: str
    n_turns: int
    n_agents: int
    hang_rate: float            # baseline rate (cascade oscillates around it)
    span_s: float               # arrival window
    service_mean_s: float
    hang_dur_mean_s: float
    oscillating: bool = False
    lanes: int = 4

    def hang_prob(self, t: float) -> float:
        if not self.oscillating:
            return self.hang_rate
        # 5%..40% wave over the 10-minute window (paper: rate-limit waves);
        # cubed duty cycle so the system spends most time near the trough
        w = 0.5 * (1 + math.sin(2 * math.pi * t / 150.0))
        return 0.03 + 0.33 * w ** 3


SCENARIOS = {
    "normal": Scenario("normal", 27, 3, 0.05, span_s=240.0,
                       service_mean_s=2.2, hang_dur_mean_s=80.0, lanes=1),
    "high_load": Scenario("high_load", 280, 10, 0.10, span_s=500.0,
                          service_mean_s=8.3, hang_dur_mean_s=78.0, lanes=4),
    "burst": Scenario("burst", 30, 5, 0.08, span_s=3.0,
                      service_mean_s=4.5, hang_dur_mean_s=34.0, lanes=4),
    "faulty": Scenario("faulty", 63, 5, 0.30, span_s=240.0,
                       service_mean_s=8.3, hang_dur_mean_s=122.0, lanes=3),
    "cascade": Scenario("cascade", 149, 5, 0.15, span_s=600.0,
                        service_mean_s=8.3, hang_dur_mean_s=66.0,
                        oscillating=True, lanes=4),
}

_CLASS_MIX = ((QueueClass.INTERACTIVE, 0.6), (QueueClass.SUBAGENT, 0.25),
              (QueueClass.BACKGROUND, 0.15))


def make_turns(scn: Scenario, seed: int = 0) -> List[Turn]:
    checksum = sum(ord(c) for c in scn.name)
    rng = random.Random((seed << 8) ^ checksum)
    arrivals = sorted(rng.uniform(0.0, scn.span_s) for _ in range(scn.n_turns))
    # deterministic hang count for the fixed-rate scenarios (the paper's
    # tables imply exact counts); cascade draws per-arrival from the wave
    if scn.oscillating:
        hang_set = {i for i, a in enumerate(arrivals)
                    if rng.random() < scn.hang_prob(a)}
    else:
        k = max(1, round(scn.n_turns * scn.hang_rate))
        hang_set = set(rng.sample(range(scn.n_turns), k))
    turns: List[Turn] = []
    for i, arrival in enumerate(arrivals):
        r = rng.random()
        acc, qc = 0.0, QueueClass.INTERACTIVE
        for cls, p in _CLASS_MIX:
            acc += p
            if r <= acc:
                qc = cls
                break
        service = max(0.4, rng.lognormvariate(
            math.log(scn.service_mean_s) - 0.18, 0.6))
        hang_dur = max(31.0, rng.lognormvariate(
            math.log(scn.hang_dur_mean_s) - 0.02, 0.2))
        turns.append(Turn(
            agent_id=f"agent-{i % scn.n_agents}",
            arrival=arrival,
            service=service,
            queue_class=qc,
            hangs=i in hang_set,
            hang_duration=hang_dur,
            tokens=int(rng.uniform(300, 1500)),
            weight=1.0 if qc == QueueClass.INTERACTIVE else 0.5,
        ))
    return turns
