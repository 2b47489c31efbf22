"""The client side of a run: the sessions' turns submitted to
``AgentRM.submit`` when they are due, and nothing else.

Turn 0 of a session is due at the session's arrival; turn k at turn k - 1's
last token (the backend's stamp) plus its pause. The loop submits what is
due, polls the handles of the turns in flight, and sleeps in between (at
most 2 ms). A turn that would take its session to ``max_len`` tokens is
not submitted, and the session ends there (``capped_sessions``). The
window opens once ``preroll_s`` has passed since the generator started
and every session has finished ``setup_turns`` turns; it closes
``seconds`` later. Submissions go on for ``extra_s`` past the close (the
traced sub-window) and then stop; the loop then waits for the turns in
flight, ``grace_s`` at most. ``on_window(start, end)`` is called once the
window's edges are known, ``on_tick(now)`` on every pass; submissions go
on past the close while ``hold()`` is true.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional

from agentbench.traffic import Session

POLL_S = 0.002


@dataclasses.dataclass
class Turn:
    session: Session
    index: int
    due: float
    log: object = None              # the backend's TurnLog
    submitted: Optional[float] = None
    handle: object = None
    delivered: Optional[str] = None
    error: Optional[str] = None
    finished: Optional[float] = None

    @property
    def prompt(self) -> str:
        return self.session.prompts[self.index]


@dataclasses.dataclass
class Window:
    start: float
    end: float
    turns: List[Turn]
    lateness_s: List[float]         # submission - due, every turn
    capped_sessions: int


def drive(rm, backend, sessions: List[Session], *, seconds: float,
          preroll_s: float, setup_turns: int, extra_s: float,
          max_len: int, vocab: int, cap: int, grace_s: float,
          clock=time.perf_counter, on_window=None, on_tick=None,
          hold=None) -> Window:
    from agentbench.traffic import tokens_of
    t0 = clock()
    heap = [(t0 + s.arrival_s, s.sid, 0) for s in sessions]
    heapq.heapify(heap)
    by_sid = {s.sid: s for s in sessions}
    held = {s.sid: 0 for s in sessions}         # tokens a session holds
    done_turns = {s.sid: 0 for s in sessions}
    turns: List[Turn] = []
    flying: List[Turn] = []
    capped = 0
    start = end = gen_end = None
    while True:
        now = clock()
        built = all(n >= setup_turns for n in done_turns.values())
        if start is None and now >= t0 + preroll_s \
                and (built or not (heap or flying)):
            start = now
        if start is not None and end is None:
            end, gen_end = start + seconds, start + seconds + extra_s
            if on_window is not None:
                on_window(start, end)
        while heap and heap[0][0] <= now and (gen_end is None
                                               or heap[0][0] < gen_end):
            due, sid, k = heapq.heappop(heap)
            s = by_sid[sid]
            grow = len(tokens_of(s.prompts[k], vocab, cap)) + s.n_new + 1
            if held[sid] + grow >= max_len:
                capped += 1
                continue
            held[sid] += grow
            t = Turn(s, k, due)
            t.log = backend.expect(s.agent_id, t.prompt)
            t.submitted = clock()
            t.handle = rm.submit(s.agent_id, t.prompt)
            turns.append(t)
            flying.append(t)
        still = []
        for t in flying:
            try:
                t.delivered = t.handle.result(timeout=0)
            except TimeoutError:
                still.append(t)
                continue
            except Exception as e:  # noqa: BLE001 — a failed turn
                t.error = f"{type(e).__name__}: {e}"
            t.finished = clock()
            s = t.session
            done_turns[s.sid] += 1
            if t.error is None and t.index + 1 < len(s.prompts):
                last = t.log.stamps[-1] if t.log.stamps else t.finished
                heapq.heappush(heap, (last + s.think_s[t.index + 1],
                                      s.sid, t.index + 1))
        flying = still
        now = clock()
        if on_tick is not None:
            on_tick(now)
        if gen_end is not None and hold is not None and hold():
            gen_end = max(gen_end, now + POLL_S)
        if gen_end is not None and now >= gen_end:
            heap = [e for e in heap if e[0] < gen_end]
            heapq.heapify(heap)
            if not flying and not heap:
                break
            if now >= gen_end + grace_s:
                break
        nxt = heap[0][0] - now if heap else POLL_S
        time.sleep(min(POLL_S, max(nxt, 0.0)))
    return Window(start=start, end=end, turns=turns,
                  lateness_s=[t.submitted - t.due for t in turns],
                  capped_sessions=capped)
