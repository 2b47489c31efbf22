"""Readings the benchmark's limits and rates are set from, many runs in one
process (one card):

    python3 -m agentbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control] [--rates 0.4,0.6,0.8]

Each seed (and rate) is a whole run as ``agentbench.run`` makes it: weights
drawn from the seed, a fresh stack, the cell's set-up and load, a window of
``--seconds``, the check. ``--control`` runs the program with its fp8 KV
cache (the control of ``kv_rel_err``); ``--reference-control`` also runs
the reference computed in fp8 over each checked session (the control of
``logit_gap``, ``control_logit_gap``); ``--rates`` sweeps the
session rate of an open-loop mix (the knee). One JSON line per run: the
compared numbers, and the end-to-end readings with the backlog's trend (the
first and second halves' median time to first token, the turns still in
flight at the close).
"""
from __future__ import annotations

import argparse
import json
import sys

from agentbench import run
from agentbench.spec import ROOT, Cell

CONTROL = {"kv_cache_dtype": "float8_e4m3fn"}


def summary(view) -> dict:
    from agentbench.view import quantile
    w = view.window
    mid = (w.start + w.end) / 2
    halves = [[t for t in view.measured() if (t.due < mid) == first]
              for first in (True, False)]

    def p50_ttft(ts):
        q = quantile([t.log.stamps[0] - t.due for t in ts
                      if t.delivered is not None and t.log.stamps], 0.5)
        return None if q is None else 1e3 * q
    late = [t for t in view.measured() if t.finished is None
            or t.finished > w.end]
    return {"turns": len(view.measured()),
            "ttft_p50_ms_halves": [p50_ttft(h) for h in halves],
            "ttft_p95_ms": 1e3 * (quantile(view.ttft_s(), 0.95) or 0),
            "turn_p95_ms": 1e3 * (quantile(view.turn_s(), 0.95) or 0),
            "itl_p95_ms": 1e3 * (quantile(view.gaps_s(), 0.95) or 0),
            "output_tokens_per_s": view.tokens_in_window() / view.seconds,
            "turns_open_at_close": len(late), "setup_s": view.setup_s,
            "steps": len(view.window_steps()),
            "mixed_steps": sum(1 for s in view.window_steps() if s.prefill)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="agentbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--reference-control", action="store_true")
    p.add_argument("--rates", default="")
    args = p.parse_args(argv)
    run.prepare_process(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("agentbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for rate in rates:
        for seed in (int(s) for s in args.seeds.split(",")):
            mix = ({"arrivals": {"sessions_per_s": rate}}
                   if rate is not None else None)
            out = run.execute(cell, seed, args.seconds, False,
                              torch.device("cuda", 0),
                              CONTROL if args.control else None, mix,
                              args.reference_control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "rate": rate, "control": args.control,
                              "numbers": out["numbers"],
                              "peak": out["peak"],
                              **summary(out["view"]),
                              "counters": out["counters"]}), flush=True)
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
