"""Deterministic fault injection for the serving stack (DESIGN.md §14).

A ``FaultPlan`` is a seeded, reproducible schedule of faults addressed to
each hardened boundary of the engine/dispatcher stack; ``ChaosBackend``
wraps a ``PagedEngineBackend`` and fires the plan's faults at the step
indices it names. The chaos soak (``benchmarks/sched_live.py --chaos``)
drives all three scheduling scenarios through a plan and asserts the
blast-radius contract: no hangs, no zombies, no lost sessions, no leaked
KV blocks, every failure a typed ``EngineError``.
"""
from repro_torch.faults.inject import ChaosBackend, FaultyKVSwapStore
from repro_torch.faults.plan import FaultPlan, FaultSpec

__all__ = ["ChaosBackend", "FaultPlan", "FaultSpec", "FaultyKVSwapStore"]
