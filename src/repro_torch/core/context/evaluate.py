"""Metrics for the context-management evaluation (paper Tables VI–IX).

The paper does not define its quality score; we construct a mechanical
rubric (documented in EXPERIMENTS.md) whose components are measured, not
asserted:

  quality = 1.0
    - 0.25 * orphan_fraction      (replies whose antecedent vanished traceless)
    - 0.20 * chaos                (unexpected physical-overflow truncations /5)
    - 0.12 * stale_noise          (old chat tokens still occupying the window)
    - 0.10 * (1 - summary_fidelity) (key-line survival inside summaries;
                                     0.5-neutral when no summaries exist)

Retention = fraction of key FACT strings still accessible (active window or
warm tier). Utilization = end-of-session window tokens / physical context.
Cost = summariser output tokens (see summarizer.py docstring).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.context.baselines import ContextStrategy
from repro_torch.core.context.message import Message, Summary


def run_session(strategy: ContextStrategy, msgs: List[Message]) -> None:
    for m in msgs:
        strategy.add(m)


def evaluate(strategy: ContextStrategy, msgs: List[Message]) -> Dict[str, float]:
    keys = [m for m in msgs if m.is_key]
    retained = sum(1 for m in keys if strategy.contains_fact(m.key_fact))
    retention = retained / max(1, len(keys))

    window = strategy.window()
    in_window_mids = {e.mid for e in window if isinstance(e, Message)}
    summarized_mids = set()
    for e in window:
        if isinstance(e, Summary):
            summarized_mids |= e.source_mids
    warm = getattr(strategy, "warm", None)
    if warm is not None:
        import json
        for row in warm.all_rows():
            summarized_mids |= set(json.loads(row[5]))

    # orphan replies: assistant msg dropped-partner (user side gone traceless)
    orphans = total_pairs = 0
    by_mid = {m.mid: m for m in msgs}
    for i in range(1, len(msgs), 2):
        a, u = msgs[i], msgs[i - 1]
        if a.mid in in_window_mids:
            total_pairs += 1
            if (u.mid not in in_window_mids
                    and u.mid not in summarized_mids):
                orphans += 1
    orphan_fraction = orphans / max(1, total_pairs)

    chaos = min(1.0, getattr(strategy, "truncation_events", 0) / 5.0) \
        if strategy.name == "No Management" else 0.0

    recent_turns = {m.turn for m in msgs[-20:]}
    stale_chat = sum(e.tokens for e in window
                     if isinstance(e, Message) and e.kind == "chat"
                     and e.turn not in recent_turns)
    stale_noise = stale_chat / max(1, strategy.window_tokens)

    # summary fidelity: of key messages folded into summaries, how many facts
    # survived inside the summary text
    folded_keys = [m for m in keys if m.mid in summarized_mids
                   and m.mid not in in_window_mids]
    if folded_keys:
        surv = sum(1 for m in folded_keys if strategy.contains_fact(m.key_fact))
        fidelity = surv / len(folded_keys)
    else:
        fidelity = 0.5              # neutral: no summaries in play

    quality = (1.0
               - 0.25 * orphan_fraction
               - 0.20 * chaos
               - 0.12 * stale_noise
               - 0.10 * (1.0 - fidelity))

    return {
        "utilization": strategy.window_tokens / strategy.physical,
        "retention": retention,
        "quality": max(0.0, quality),
        "compact_cost": strategy.compaction_cost,
        "truncations": getattr(strategy, "truncation_events", 0),
    }
