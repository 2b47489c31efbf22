"""The one traffic generator: agent sessions from a mix's parameters.

A session arrives (open loop: Poisson at ``arrivals.sessions_per_s``; or
all at the start, ``arrivals.sessions``), then runs its turns closed loop:
turn k is due ``think_s`` after turn k - 1's last token. Its first prompt
is a prefix shared by every session (``first_prompt.shared_prefix_tokens``,
block-aligned so the pool can share its pages) and a task of its own; each
later prompt is a tool result (``later_prompt``: uniform, or Pareto-tailed
and cut at ``max``). Each session generates ``max_new_tokens`` plus a
jitter of 0..``new_tokens_jitter`` tokens a turn, which the program's
backend derives from the agent's name, so names are chosen to give the
jitters drawn here.

Every seed gets the same schedule: the sizes, gaps and pauses are the
midpoints of equal-probability strata, in one order drawn once (from seed
0), so every run offers the same work at the same times. The seed sets the
token contents alone. One character is one token (ASCII 1..127).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Session:
    sid: int
    agent_id: str
    arrival_s: float            # after the generator's start
    n_new: int                  # tokens each of its turns generates
    prompts: List[str]          # one per turn
    think_s: List[float]        # pause before each turn (0 for the first)


def tokens_of(text: str, vocab: int, cap: int) -> np.ndarray:
    """The token ids a prompt becomes: its first ``cap`` UTF-8 bytes, each
    ``b % (vocab - 2) + 1``."""
    b = np.frombuffer(text.encode("utf-8", "ignore"), dtype=np.uint8)[:cap]
    return b.astype(np.int64) % max(vocab - 2, 2) + 1


def strata(n: int, rng: np.random.Generator) -> np.ndarray:
    """n probabilities, the midpoints of n equal strata, in ``rng``'s
    order."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def _ints(u: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)


def _later_sizes(spec: Dict, u: np.ndarray) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return _ints(u, lo, hi)
    if spec["dist"] == "pareto":
        # Pareto of index alpha from lo, cut at hi: the inverse of the
        # truncated distribution function
        a = float(spec["alpha"])
        tail = 1.0 - (lo / hi) ** a
        return np.floor(lo * (1.0 - u * tail) ** (-1.0 / a)).astype(np.int64)
    raise ValueError(f"unknown prompt distribution {spec['dist']!r}")


def _text(rng: np.random.Generator, n: int) -> str:
    return "".join(map(chr, rng.integers(1, 128, n)))


def agent_for(sid: int, jitter: int, offset: int, tag: str) -> str:
    """A name whose ``crc32 % (jitter + 1)`` is ``offset``: the backend
    draws a session's generation length from its agent's name."""
    k = 0
    while True:
        name = f"{tag}{sid}-{k}"
        if not jitter or zlib.crc32(name.encode()) % (jitter + 1) == offset:
            return name
        k += 1


def n_sessions(mix: Dict, horizon_s: float) -> int:
    arr = mix["arrivals"]
    if arr["process"] == "at_start":
        return int(arr["sessions"])
    if arr["process"] == "poisson":
        return int(math.ceil(float(arr["sessions_per_s"]) * horizon_s)) + 1
    raise ValueError(f"unknown arrival process {arr['process']!r}")


def sessions(mix: Dict, seed: int, horizon_s: float,
             tag: str = "agent") -> List[Session]:
    """The sessions of one run, arriving within about ``horizon_s`` of the
    generator's start (Poisson) or at its start."""
    order, rng = np.random.default_rng(0), np.random.default_rng(
        [int(seed), 1])
    n = n_sessions(mix, horizon_s)
    arr = mix["arrivals"]
    if arr["process"] == "poisson":
        gaps = -np.log1p(-strata(n, order)) / float(arr["sessions_per_s"])
        arrivals = np.cumsum(gaps)
    else:
        arrivals = np.zeros(n)
    turns = _ints(strata(n, order), *mix["turns_per_session"])
    first = mix["first_prompt"]
    tasks = _ints(strata(n, order), *first["tokens"])
    m = int(turns.sum() - n)
    later = _later_sizes(mix["later_prompt"], strata(m, order))
    think = np.asarray(mix["think_s"], float)
    pauses = think[0] + strata(m, order) * (think[1] - think[0])
    jitter = int(mix["new_tokens_jitter"])
    offsets = _ints(strata(n, order), 0, jitter) if jitter else np.zeros(n, int)
    prefix = _text(rng, int(first["shared_prefix_tokens"]))
    out, j = [], 0
    for i in range(n):
        prompts = [prefix + _text(rng, int(tasks[i]))]
        prompts += [_text(rng, int(s)) for s in later[j:j + turns[i] - 1]]
        out.append(Session(
            sid=i, agent_id=agent_for(i, jitter, int(offsets[i]), tag),
            arrival_s=float(arrivals[i]),
            n_new=int(mix["max_new_tokens"]) + int(offsets[i]),
            prompts=prompts,
            think_s=[0.0] + [float(p) for p in pauses[j:j + turns[i] - 1]]))
        j += int(turns[i]) - 1
    cap = int(mix["prompt_tokens"])
    longest = max(len(p) for s in out for p in s.prompts)
    if longest > cap:
        raise ValueError(f"a prompt of {longest} tokens exceeds the "
                         f"backend's cap of {cap}")
    return out


def worst_session_tokens(mix: Dict, turns: int) -> int:
    """The most tokens a session of ``turns`` turns can hold: the longest
    first prompt, the longest later prompts and the longest generations."""
    first = mix["first_prompt"]
    gen = int(mix["max_new_tokens"]) + int(mix["new_tokens_jitter"])
    return (int(first["shared_prefix_tokens"]) + int(first["tokens"][1])
            + (turns - 1) * int(mix["later_prompt"]["max"]) + turns * gen)
