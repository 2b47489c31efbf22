"""One run of one cell of the port's benchmark.

    python3 -m agentbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the card(s) the cell asks
for. Set-up draws the weights from the seed on the card, builds the stack
(``agentbench.stack``), captures every bucket width, and runs the traffic's
own set-up (a pre-roll of arrivals, or the sessions' first turns); the
window then measures ``--seconds``. With ``--trace 1`` a profiled
sub-window follows the close while the traffic goes on, and the per-layer
metrics are reported instead of the end-to-end ones. Once every turn has
come back, the result is checked (``agentbench.check``) and one JSON
object is printed as the last line of standard output; the numbers
compared, each beside its limit, are also the last lines of standard
error. Without a card, or with fewer than the cell asks for, it prints no
result and exits 2; where JAX or the JAX package has been loaded by the
time the result would be printed, it names them and exits 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from agentbench.spec import ROOT, Cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 2.0           # the profiled sub-window
GRACE_S = 60.0          # how long the close waits for turns in flight


def prepare_process(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; the program (the
    checkout's ``src``) on the path. Called before torch is imported."""
    build = root / "build" / "agentbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "extensions"))
    for src in (str(root / "src"), str(ROOT / "src")):
        if src not in sys.path and Path(src).is_dir():
            sys.path.insert(0, src)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or its package,
    compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="agentbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            conf_over: Optional[Dict] = None,
            mix_over: Optional[Dict] = None,
            reference_control: bool = False) -> Dict:
    """Set-up, window, check: everything a run measures, as a dict with
    ``view`` (for the readers) and the compared ``numbers``.
    ``conf_over`` / ``mix_over`` are laid over the configuration and the
    cell's mix (the control's fp8 cache; a sweep's rate);
    ``reference_control`` also reads the fp8 reference's logit gap."""
    import torch

    from agentbench import check, client, stack, traffic, weights
    from agentbench import trace as tracing
    from agentbench.spec import merged
    from agentbench.view import RunView

    conf = merged(cell.config, conf_over or {})
    mix = merged(cell.traffic, mix_over or {})
    seed = int(seed) % (1 << 63)
    kind = cell.kind
    m = kind.dims(conf)
    dtype = getattr(torch, conf["torch_dtype"])
    raw = weights.draw(m, kind.layer_groups(m), seed, device, dtype)
    clock = time.perf_counter
    sut = stack.build(conf, kind.port_config(conf), mix, raw, device,
                      clock=clock)
    tracer = (tracing.Tracer(TRACE_S, clock, sut.backend.step_lock)
              if trace else None)
    if tracer is not None and device.type == "cuda":
        tracer.warm(device)
    extra = TRACE_S if trace else 0.0
    horizon = float(mix["preroll_s"]) + seconds + extra
    sessions = traffic.sessions(mix, seed, horizon)

    def on_window(start, end):
        if tracer is not None:
            tracer.start_at = end

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        win = client.drive(
            sut.rm, sut.backend, sessions, seconds=seconds,
            preroll_s=float(mix["preroll_s"]),
            setup_turns=int(mix["setup_turns"]), extra_s=extra,
            max_len=kind.max_context(conf, sut.engine.max_len),
            vocab=sut.cfg.vocab_size,
            cap=int(mix["prompt_tokens"]), grace_s=GRACE_S, clock=clock,
            on_window=on_window,
            on_tick=tracer.tick if tracer is not None else None,
            hold=(lambda: not tracer.done) if tracer is not None else None)
        if tracer is not None:
            tracer.stop()
    finally:
        sut.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    eng, be = sut.engine, sut.backend
    reading = tracing.read(tracer, be.steps) if tracer is not None else None
    item = eng.cache.pools()[0]["k"].element_size()
    view = RunView(dims=m, kind=kind, window=win, steps=be.steps,
                   setup_s=win.start - T_PROCESS,
                   device_name=(torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                   max_batch=eng.max_batch, kv_itemsize=item, trace=reading)
    bad, lost = check.delivery(win.turns)
    picked = check.pick_sessions(
        win.turns, seed, int(cell.check.get("served_tokens", 300)),
        int(cell.check.get("sessions", 3)))
    pages = [check.copy_pages(eng, be, s[0].session.agent_id)
             for s in picked]
    blank = check.unwritten(eng, be)
    counters = {"prefix_lookups": eng.cache.prefix_lookups,
                "prefix_hits": eng.cache.prefix_hits,
                "graph": eng.graph_stats(), "trace_buckets":
                sorted(eng.trace_buckets), "compile_s": sut.compile_s,
                "pool_blocks": eng.cache.num_blocks,
                "pool_pages_peak": be.pages_peak,
                "swaps_out": eng.swap.swaps_out,
                "trace_attributed": reading.attributed if reading else None}
    if tracer is not None and tracer.done:
        late = sorted(t.submitted - t.due for t in win.turns
                      if tracer.t_start - tracer.pause_s <= t.due
                      < tracer.t_stop)
        counters["trace_start_pause_ms"] = 1e3 * tracer.pause_s
        counters["trace_stop_ms"] = 1e3 * tracer.stop_s
        counters["trace_turns_due"] = len(late)
        counters["trace_generator_late_max_ms"] = \
            1e3 * late[-1] if late else 0.0
    del sut, eng, be, reading
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = {"turns_lost": lost, "delivery_mismatches": bad,
               "kv_tokens_unwritten": blank,
               **check.compare(cell.reference, conf, raw, picked, pages,
                               m["V"], int(mix["prompt_tokens"]),
                               reference_control)}
    counters["check_s"] = time.perf_counter() - t_check
    return {"view": view, "numbers": numbers, "peak": peak,
            "counters": counters}


def judge(numbers: Dict, limits: Dict) -> Dict[str, Dict]:
    """Each compared number beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def main(argv=None, *, device=None, root: Path = ROOT,
         conf_over: Optional[Dict] = None) -> int:
    """The command; ``device`` skips the look for a card (tests)."""
    args = parse(argv)
    prepare_process(root)
    cell = Cell(args.workload, root)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            say(f"agentbench: {args.workload} needs {cell.chips} CUDA "
                f"device(s); torch.cuda.is_available()="
                f"{torch.cuda.is_available()}, device_count()="
                f"{torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  conf_over)
    from agentbench.view import quantile
    view = out["view"]
    metrics = {}
    for spec in cell.metrics(bool(args.trace)):
        value = cell.reader(spec["name"])(view)
        if value is not None and math.isfinite(value):
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        else:
            say(f"agentbench: {spec['name']} read {value}; left out")
    checks = judge(out["numbers"], cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    w = view.window
    measured = view.measured()
    failed = sum(1 for t in measured if t.delivered is None)
    device_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": view.device_name, "count": cell.chips,
                  "memory_peak_bytes": out["peak"]}
    result = {"correct": correct, "attempted": len(measured),
              "failed": failed, "metrics": metrics, "device": device_out}
    if view.trace is not None:
        device_out["busy_s"] = view.trace.busy_s
        device_out["window_s"] = view.trace.window_s
        result["breakdown"] = {"device_ops": view.trace.device_ops,
                               "idle_gaps": view.trace.idle_gaps}
    result["checks"] = checks
    lateness = sorted(view.window.lateness_s)
    gaps = [g for g in view.gaps_s() if math.isfinite(g)]
    say(json.dumps({"window_s": w.end - w.start, "turns": len(w.turns),
                    "steps": len(view.steps),
                    "capped_sessions": w.capped_sessions,
                    "generator_late_p99_ms": 1e3 * lateness[
                        int(0.99 * (len(lateness) - 1))] if lateness else 0,
                    "gap_ms_p50_p90_p95_p99": [
                        1e3 * (quantile(gaps, q) or 0)
                        for q in (0.5, 0.9, 0.95, 0.99)],
                    "numbers": out["numbers"], **out["counters"]}))
    for name, c in checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    # after the window, the check's reference and every reader
    found = forbidden_modules()
    if found:
        say(f"agentbench: the run loaded {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
