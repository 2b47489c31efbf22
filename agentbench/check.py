"""The comparison that decides ``correct``.

Three layers are judged on what the timed path produced:

  * AgentRM's delivery: every turn's answer, as ``AgentRM.submit``'s handle
    gave it, is the tokens the engine sampled for that turn, all
    ``n_new`` of them (``delivery_mismatches``; a turn that never came or
    failed is ``turns_lost``);
  * the paged KV pool: the keys and values of a sample of sessions'
    histories, read from their pages once the window has closed, against
    the reference's (``kv_rel_err``: the worst layer's ``|pool - ref| /
    |ref|`` over the sample, K and V);
  * the captured model step's tokens: each served token of the sampled
    sessions, against the reference's logits at its position
    (``logit_gap``: the widest gap by which a served token's logit lies
    below the reference's best; the step samples greedily).

Every session's pages are also read on the device for tokens that no step
wrote: a token whose keys and values are all zero bytes in some layer
(``kv_tokens_unwritten``; the pool starts zeroed and no page is released
during a run), so a fault confined to some batch rows shows whichever
sessions the sample holds.

The sample is drawn from the seed among the sessions whose turns all
finished, the one holding the most tokens always in it, until it serves
``check.served_tokens`` tokens or holds ``check.sessions`` sessions. The
pages are copied out first; then the program is freed and the reference
runs, one session at a time.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np
import torch

from agentbench.traffic import tokens_of


def parse_answer(text: str) -> List[int]:
    if not text.startswith("tok:"):
        raise ValueError(f"not an answer of tokens: {text[:40]!r}")
    return [int(x) for x in text[4:].split(",") if x]


def delivery(turns) -> Tuple[int, int]:
    """(mismatches, lost): answers that are not the engine's tokens of the
    turn or not ``n_new`` long; turns that failed or never finished."""
    bad = lost = 0
    for t in turns:
        if t.delivered is None:
            lost += 1
            continue
        toks = parse_answer(t.delivered)
        if toks != t.log.tokens or len(toks) != t.session.n_new:
            bad += 1
    return bad, lost


def pick_sessions(turns, seed: int, want_tokens: int,
                  most: int) -> List[List]:
    """Each picked session's turns in order."""
    by: Dict[int, List] = {}
    for t in turns:
        by.setdefault(t.session.sid, []).append(t)
    whole = {sid: sorted(ts, key=lambda t: t.index) for sid, ts in by.items()
             if all(t.delivered is not None for t in ts)}
    if not whole:
        return []
    size = {sid: sum(len(t.prompt) + t.session.n_new for t in ts)
            for sid, ts in whole.items()}
    first = max(size, key=size.get)
    rest = [sid for sid in sorted(whole) if sid != first]
    order = [first] + list(np.random.default_rng(seed).permutation(rest))
    out, served = [], 0
    for sid in order:
        if len(out) == most or served >= want_tokens:
            break
        out.append(whole[int(sid)])
        served += sum(t.session.n_new for t in whole[int(sid)])
    return out


def history(session_turns, vocab: int, cap: int) -> Tuple[torch.Tensor,
                                                           List[int],
                                                           List[int]]:
    """The session's token ids in order (every prompt, then its answer),
    the positions of the served tokens and the served tokens."""
    ids: List[int] = []
    pos: List[int] = []
    served: List[int] = []
    for t in session_turns:
        ids.extend(int(x) for x in tokens_of(t.prompt, vocab, cap))
        out = parse_answer(t.delivered)
        pos.extend(range(len(ids), len(ids) + len(out)))
        served.extend(out)
        ids.extend(out)
    return torch.tensor(ids, dtype=torch.long), pos, served


def copy_pages(engine, backend, agent_id: str) -> Tuple[torch.Tensor,
                                                        torch.Tensor, int]:
    """The session's cached keys and values, (L, n, hkv, hd) float32 each,
    as its pages hold them, and n."""
    req = engine.reqs[backend.sessions[agent_id]]
    n = req.table.num_tokens
    blocks = torch.tensor(req.table.blocks, dtype=torch.long,
                          device=engine.device)
    k_pool, v_pool = engine.cache.full_pools()

    def take(pool):
        x = pool[:, blocks]                       # (L, pages, blk, hkv, hd)
        return x.reshape(x.shape[0], -1, *x.shape[3:])[:, :n].float()
    return take(k_pool), take(v_pool), n


def unwritten(engine, backend) -> int:
    """Tokens of every session's history (all but its last sampled token)
    whose keys and values are all zero bytes in some layer."""
    k_pool, v_pool = engine.cache.full_pools()
    count = 0
    for rid in backend.sessions.values():
        req = engine.reqs.get(rid)
        if req is None or req.table is None:
            continue
        n = req.table.num_tokens
        blocks = torch.tensor(req.table.blocks, dtype=torch.long,
                              device=engine.device)
        written = None
        for pool in (k_pool, v_pool):
            x = pool[:, blocks].reshape(pool.shape[0], -1,
                                        *pool.shape[3:])[:, :n]
            w = x.reshape(*x.shape[:2], -1).view(torch.uint8).ne(0).any(-1)
            written = w if written is None else written | w
        count += int((~written).any(0).sum())
    return count


def compare(ref, conf: Dict, raw: Dict, picked, pages, vocab: int,
            cap: int, control: bool = False) -> Dict[str, float]:
    """Run the reference ``ref`` (the kind's module under ``reference/``)
    over each picked session; the worst KV error and logit gap. With
    ``control`` also the reference computed in fp8 over the same prompts
    and tokens (``control_logit_gap``: the gap of the token it puts first
    at each served position)."""
    ref.exact_float32()
    dev = raw["embed"].device
    worst_kv, worst_gap, n_served, n_struct = 0.0, 0.0, 0, 0
    worst_control = 0.0
    for sess, (k_pg, v_pg, n) in zip(picked, pages):
        ids, pos, served = history(sess, vocab, cap)
        if n != len(ids) - 1:
            # the pool must hold every token but the last one sampled
            n_struct += 1
            continue
        errs: List[float] = []

        def sink(li, k, v):
            for got, want in ((k_pg[li], k[:n]), (v_pg[li], v[:n])):
                errs.append(float((got - want).norm() / want.norm()))
        logits = ref.run(conf, raw, ids.to(dev),
                         torch.tensor(pos, device=dev) - 1, sink)
        got = torch.tensor(served, device=dev)
        gap = logits.max(-1).values - logits.gather(1, got[:, None])[:, 0]
        worst_gap = max(worst_gap, float(gap.max()))
        worst_kv = max(worst_kv, max(errs))
        if control:
            low = ref.run(conf, raw, ids.to(dev),
                          torch.tensor(pos, device=dev) - 1, fp8=True)
            first = low.argmax(-1)
            worst_control = max(worst_control, float(
                (logits.max(-1).values
                 - logits.gather(1, first[:, None])[:, 0]).max()))
            del low
        n_served += len(served)
        del logits
        gc.collect()
    out = {"kv_rel_err": worst_kv, "logit_gap": worst_gap,
           "history_mismatches": n_struct, "served_tokens_checked": n_served}
    if control:
        out["control_logit_gap"] = worst_control
    return out
