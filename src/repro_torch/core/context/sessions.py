"""Synthetic agent sessions for the context-management evaluation
(paper §VI.C): 50/100/200-turn and multi-topic, with exact message counts,
token totals, and key-message counts from the paper. Key information is
embedded as unique FACT lines so retention is measured by string survival.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from repro_torch.core.context.message import Message

_FILLER = ("the agent considered the request and responded with details "
           "about the ongoing task including status notes and follow ups "
           "plus assorted narrative context that matters less later").split()

KEY_KINDS = ("structured", "decision", "commitment", "fact")


@dataclass(frozen=True)
class SessionSpec:
    name: str
    n_msgs: int
    total_tokens: int
    n_keys: int
    n_topics: int = 1


SESSIONS = {
    "50_turn": SessionSpec("50_turn", 100, 51_000, 13),
    "100_turn": SessionSpec("100_turn", 200, 105_000, 27),
    "200_turn": SessionSpec("200_turn", 400, 202_000, 47),
    "multi_topic": SessionSpec("multi_topic", 240, 116_000, 35, n_topics=4),
}


def _filler_text(rng: random.Random, n_tokens: int) -> str:
    words = [rng.choice(_FILLER) for _ in range(max(4, n_tokens))]
    # break into lines of ~14 words
    lines = [" ".join(words[i:i + 14]) for i in range(0, len(words), 14)]
    return "\n".join(lines)


def make_session(spec: SessionSpec, seed: int = 0) -> List[Message]:
    rng = random.Random(seed * 7919 + len(spec.name))
    per_msg = spec.total_tokens / spec.n_msgs
    key_positions = set(
        int((i + 0.5) * spec.n_msgs / spec.n_keys) for i in range(spec.n_keys))
    msgs: List[Message] = []
    for i in range(spec.n_msgs):
        topic = f"topic-{i * spec.n_topics // spec.n_msgs}"
        n_tok = max(8, int(rng.lognormvariate(0, 0.35) * per_msg))
        role = "user" if i % 2 == 0 else "assistant"
        if i in key_positions:
            kind = rng.choice(KEY_KINDS)
            fact = f"FACT-{i:05d}-{rng.randrange(16**6):06x}"
            marker = {"structured": f"RESULT: {{\"id\": \"{fact}\"}}",
                      "decision": f"DECISION: adopt {fact}",
                      "commitment": f"COMMITMENT: deliver {fact} by friday",
                      "fact": f"{fact}: the canonical value is 42"}[kind]
            body = _filler_text(rng, n_tok - len(marker.split()))
            msgs.append(Message(role=role, text=marker + "\n" + body,
                                turn=i, topic=topic, kind=kind,
                                is_key=True, key_fact=fact))
        else:
            kind = "chat" if rng.random() < 0.8 else "tool"
            msgs.append(Message(role=role, text=_filler_text(rng, n_tok),
                                turn=i, topic=topic, kind=kind))
    return msgs
