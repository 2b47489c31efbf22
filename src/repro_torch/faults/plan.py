"""Seeded fault plans: a deterministic schedule of injected failures.

``FaultPlan.generate(seed, n_steps, ...)`` is a pure function of its
arguments — the same seed always yields the same faults at the same step
indices, so a chaos soak that trips an invariant can be replayed exactly.
Each ``FaultSpec`` addresses one hardened boundary:

  ``step_exception``   transient exception from the megastep (retry tier)
  ``step_hang``        megastep blocks for ``param`` seconds, then raises
                       (exercises the dispatcher watchdog deadline)
  ``poison_row``       one active row's logits turn NaN (blast-radius = 1)
  ``kv_squat``         ``param`` fraction of free KV blocks held hostage
                       for a few steps (admission-pressure degradation)
  ``swap_write_error`` next swap-store put raises (hibernate/evict path)
  ``swap_read_error``  next swap-store read raises (wake/admit path)
  ``swap_corrupt``     bytes of one swapped payload flipped in place
                       (checksum detection at swap-in)
  ``rate_limit``       ``param`` simulated upstream 429s fed to the AIMD
                       admission controller
  ``crash``            fatal engine crash (journal rebuild + replay)

Fleet-level kinds (no-ops against a single-engine backend — the hook
methods only exist on ``FleetBackend``; injections against backends
without the hook are decremented back out of ``injected``):

  ``engine_loss``          one alive fleet engine dies; ``param`` picks it
                           (never the last engine — that would be "cluster
                           loss", a different drill)
  ``migration_interrupt``  every in-flight fluid migration aborts at its
                           next tick (streaming phase only; zero leaks)
  ``network_delay``        ``param`` seconds of stall on the next KV page
                           stream tick (slow interconnect, not a hang)

The determinism contract: generation draws from ONE ``random.Random``
stream, iterating kinds in ``FAULT_KINDS`` order with one draw per kind
per step regardless of whether it fires — so a given seed always yields
the same plan, with or without chaos actually enabled for a kind.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterable, List, Optional

__all__ = ["FaultSpec", "FaultPlan", "FAULT_KINDS"]

FAULT_KINDS = ("step_exception", "step_hang", "poison_row", "kv_squat",
               "swap_write_error", "swap_read_error", "swap_corrupt",
               "rate_limit", "crash",
               # fleet-level kinds (appended — earlier kinds keep their
               # position in the per-step draw order)
               "engine_loss", "migration_interrupt", "network_delay")

# Default per-step firing probability of each kind. Crashes are rare —
# each one tears the engine down and replays every in-flight turn. The
# fleet kinds default to 0 (opt-in): against a single engine they are
# meaningless, and a fleet soak enables them explicitly.
DEFAULT_RATES: Dict[str, float] = {
    "step_exception": 0.020,
    "step_hang": 0.004,
    "poison_row": 0.010,
    "kv_squat": 0.008,
    "swap_write_error": 0.006,
    "swap_read_error": 0.006,
    "swap_corrupt": 0.004,
    "rate_limit": 0.010,
    "crash": 0.002,
    "engine_loss": 0.0,
    "migration_interrupt": 0.0,
    "network_delay": 0.0,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: fires when the wrapped backend reaches ``step``."""
    step: int
    kind: str
    param: float = 0.0   # kind-specific knob (hang seconds, squat frac, …)

    def to_dict(self) -> Dict:
        return {"step": self.step, "kind": self.kind, "param": self.param}


class FaultPlan:
    def __init__(self, faults: Iterable[FaultSpec] = (), seed: int = 0):
        self.seed = seed
        self.faults: List[FaultSpec] = sorted(faults, key=lambda f: f.step)
        self._by_step: Dict[int, List[FaultSpec]] = {}
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}")
            self._by_step.setdefault(f.step, []).append(f)

    def at(self, step: int) -> List[FaultSpec]:
        return self._by_step.get(step, [])

    def __len__(self) -> int:
        return len(self.faults)

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in FAULT_KINDS}
        for f in self.faults:
            out[f.kind] += 1
        return out

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "n_faults": len(self.faults),
                "counts": self.counts(),
                "faults": [f.to_dict() for f in self.faults]}

    # --------------------------------------------------------- generation
    @classmethod
    def generate(cls, seed: int, n_steps: int,
                 rates: Optional[Dict[str, float]] = None,
                 hang_s: float = 0.6, squat_frac: float = 0.5,
                 burst: int = 3, warmup: int = 4,
                 net_delay_s: float = 0.05) -> "FaultPlan":
        """Deterministic plan over ``n_steps`` backend steps. ``rates``
        overrides per-kind firing probabilities (a kind absent from the
        override keeps its default; rate 0 disables it). The first
        ``warmup`` steps are fault-free so every scenario gets admitted
        work before the chaos starts."""
        rng = random.Random(seed)
        eff = dict(DEFAULT_RATES)
        if rates:
            eff.update(rates)
        faults: List[FaultSpec] = []
        for step in range(warmup, n_steps):
            # iterate kinds in fixed order so the rng stream is stable
            for kind in FAULT_KINDS:
                if rng.random() >= eff.get(kind, 0.0):
                    continue
                if kind == "step_hang":
                    param = hang_s * rng.uniform(0.8, 1.2)
                elif kind == "kv_squat":
                    param = squat_frac * rng.uniform(0.5, 1.0)
                elif kind == "rate_limit":
                    param = float(rng.randint(1, burst))
                elif kind == "poison_row":
                    param = float(rng.randrange(1 << 16))  # victim pick
                elif kind == "engine_loss":
                    param = float(rng.randrange(1 << 16))  # victim engine
                elif kind == "network_delay":
                    param = net_delay_s * rng.uniform(0.5, 1.5)
                else:
                    param = 0.0
                faults.append(FaultSpec(step, kind, param))
        return cls(faults, seed=seed)
