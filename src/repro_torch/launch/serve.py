"""Serving driver: AgentRM middleware over the port's inference engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --paged --agents 3 --turns 9

The port of ``repro.launch.serve``, with its functions, flags and printed
lines. It wires every paper component end to end: agents submit turns ->
MLFQ + admission control -> engine lanes (continuous-batching slots) -> CLM
accumulates each agent's context with PSI injection; the reaper watches
heartbeats emitted per decode step.

``--device`` (default ``cuda``) places the weights and every engine; on a
host without a card ``cuda`` raises, and only ``--device cpu`` runs the
plain PyTorch path there (``--smoke --device cpu`` for a quick run).

``--paged`` swaps the dense slot engine (kernels K3 and K4) for the paged
megastep engine (kernel K1) behind the fused iteration-level dispatcher;
``--token-budget N`` turns on the stall-free token-budget pack (decode-
first, bounded pow2 buckets). The budget is validated by the engine: it
must be at least ``--max-batch`` so every active row makes progress every
step, and it is clamped to ``max_len``. Unset keeps fixed-chunk megastep
behaviour.

``--trace-out trace.json`` records the run in the flight recorder and
exports a Chrome trace-event file on exit (open in Perfetto / about:
tracing); ``--metrics-dump metrics.json`` writes the unified registry
snapshot.

``--mesh tp=N`` (requires ``--paged``; N must divide the model's KV-head
count) serves through the tensor-parallel megastep: the first N visible
devices of ``--device``'s type, one shard each (the CPU counts as one
device, so ``--device cpu`` takes ``tp=1``; ``launch.mesh.make_tp_mesh
(devices=[...])`` puts several shards on one device). Every engine gets
the mesh, a fleet's too.

``--fleet N`` (requires ``--paged``) runs N engines — named engine0..
engineN-1, sharing one Observability — behind the elastic fleet router:
admission places each agent on the least-loaded engine, sessions migrate
between engines via checksummed KV-page streams, and an engine loss fails
in-flight turns typed while journaled sessions restore bit-exactly on
survivors. ``--kill IDX`` kills that engine after the first completed turn
(failed turns are resubmitted to demonstrate failover); ``--drain IDX``
gracefully drains it instead. ``--spill-dir DIR`` puts a crc32-checked
disk tier below each engine's host-RAM swap store (``--spill-capacity-mb``
bounds the RAM tier).
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import AgentRM, AgentRMConfig
from repro_torch.core.scheduler.task import QueueClass
from repro_torch.distributed.elastic import FleetBackend
from repro_torch.distributed.sharding import validate_tp
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import build
from repro_torch.obs import Observability, TraceConfig
from repro_torch.serving import (BackpressureError, DiskTierKVSwapStore,
                                 EngineBackend, EngineLostError,
                                 InferenceEngine, PagedEngineBackend,
                                 PagedInferenceEngine, SessionJournal)
from repro_torch.core.middleware import TurnCancelled


def parse_mesh_spec(spec: str) -> int:
    """``tp=N`` -> N. ValueError on anything else (axis names other than
    tp are reserved for future mesh shapes)."""
    key, sep, val = spec.partition("=")
    if key != "tp" or not sep:
        raise ValueError(f"expected tp=N, got {spec!r}")
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"tp must be an integer, got {val!r}") from None


def build_mesh(cfg, args):
    """CLI mesh validation: every mesh-shape error (bad spec, tp not
    dividing the model's heads, not enough devices) becomes a SystemExit
    here — same pattern as --token-budget — so the engine never builds
    with an invalid mesh."""
    if not getattr(args, "mesh", None):   # older test Namespaces lack it
        return None
    if not args.paged:
        raise SystemExit("--mesh requires --paged (only the megastep "
                         "engine is sharded; the dense slot engine is "
                         "single-device)")
    try:
        tp = parse_mesh_spec(args.mesh)
        validate_tp(cfg, tp)
        return make_tp_mesh(tp, device=getattr(args, "device", "cuda"))
    except ValueError as e:
        raise SystemExit(f"invalid --mesh: {e}") from e


def build_obs(args) -> Observability:
    """Observability context from CLI args; validation errors surface as
    CLI errors, same pattern as --token-budget."""
    try:
        trace = TraceConfig(enabled=bool(args.trace_out),
                            capacity=args.trace_capacity)
    except ValueError as e:
        raise SystemExit(f"invalid --trace-capacity: {e}") from e
    return Observability(trace=trace)


def build_backend(cfg, params, args, obs=None):
    """Engine + middleware backend from CLI args (separated for tests)."""
    if not args.paged:
        if args.token_budget:
            raise SystemExit("--token-budget requires --paged (the dense "
                             "slot engine has no megastep to budget)")
        if getattr(args, "mesh", None):
            raise SystemExit("--mesh requires --paged (only the megastep "
                             "engine is sharded; the dense slot engine is "
                             "single-device)")
        engine = InferenceEngine(cfg, params, max_slots=args.lanes,
                                 max_len=args.max_len, device=args.device)
        return engine, EngineBackend(engine,
                                     max_new_tokens=args.max_new_tokens)
    mesh = build_mesh(cfg, args)    # mesh validation, as a CLI error

    def make_store(name: str):
        """Optional disk tier below the host-RAM swap store; each engine
        gets its own spill subdirectory so keys never collide."""
        if not getattr(args, "spill_dir", None):
            return None
        return DiskTierKVSwapStore(
            os.path.join(args.spill_dir, name),
            capacity_bytes=args.spill_capacity_mb << 20)

    def make_engine(name: str = "engine"):
        return PagedInferenceEngine(
            cfg, params, num_blocks=args.num_blocks,
            block_size=args.block_size, max_batch=args.max_batch,
            max_len=args.max_len, prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget or None, mesh=mesh, obs=obs,
            swap_store=make_store(name), name=name, device=args.device)

    journal = None
    if getattr(args, "journal_dir", None):
        # crash-safe recovery (DESIGN.md §14): committed turns journal to
        # disk; a fatal engine fault rebuilds via the factory and restores.
        # With a fleet the journal is SHARED — it is what lets a session
        # journaled on a dead engine wake bit-exactly on a survivor.
        journal = SessionJournal(args.journal_dir)

    fleet_n = getattr(args, "fleet", 1) or 1
    if fleet_n > 1:
        members = []
        for i in range(fleet_n):
            name = f"engine{i}"

            def factory(name=name):
                return make_engine(name)

            try:
                eng = factory()
            except ValueError as e:
                raise SystemExit(f"invalid --token-budget: {e}") from e
            eng.compile_buckets()
            members.append(PagedEngineBackend(
                eng, max_new_tokens=args.max_new_tokens, journal=journal,
                engine_factory=factory if journal else None))
        fleet = FleetBackend(members, journal=journal)
        return fleet, fleet

    try:
        engine = make_engine()
    except ValueError as e:         # budget validation, as a CLI error
        raise SystemExit(f"invalid --token-budget: {e}") from e
    # build the kernels and run every megastep bucket once so live traffic
    # never blocks the fused dispatcher (and its heartbeats) in a build
    engine.compile_buckets()
    return engine, PagedEngineBackend(engine,
                                      max_new_tokens=args.max_new_tokens,
                                      journal=journal,
                                      engine_factory=(make_engine if journal
                                                      else None))


def print_obs_summary(obs: Observability, engine_names=("engine",)):
    """One-screen curated end-of-run summary from the unified registry.

    Per-engine metrics live under ``<name>.*`` (and ``kv.<name>.*`` for
    non-default names), so a fleet run passes every engine's name and
    the summary aggregates: counters sum, histograms merge bucket-wise
    before the quantile is taken."""
    from repro_torch.obs.metrics import Histogram
    m = obs.metrics

    def q(suffix, qq):
        hs = [h for h in (m.get(f"{n}.{suffix}") for n in engine_names)
              if h is not None and h.count]
        if not hs:
            return 0.0
        merged = Histogram("merged", hs[0].bounds)
        for h in hs:
            merged.counts = merged.counts + h.counts
            merged.count += h.count
            merged.sum += h.sum
            merged.min = min(merged.min, h.min)
            merged.max = max(merged.max, h.max)
        return (merged.quantile(qq) or 0.0) * 1000

    def c(name):
        c_ = m.get(name)
        return int(c_.value) if c_ is not None else 0

    def ce(suffix):
        return sum(c(f"{n}.{suffix}") for n in engine_names)

    real, disp = ce("tokens_real"), ce("tokens_dispatched")
    pad = 1.0 - real / disp if disp else 0.0
    print("[serve] --- metrics (unified registry) ---")
    print(f"[serve] ttft  p50 {q('ttft_s', .5):.0f}ms  "
          f"p95 {q('ttft_s', .95):.0f}ms | "
          f"itl p50 {q('itl_s', .5):.1f}ms  "
          f"p95 {q('itl_s', .95):.1f}ms | "
          f"step p50 {q('step_s', .5):.1f}ms  "
          f"p95 {q('step_s', .95):.1f}ms")
    print(f"[serve] tokens real {real} / dispatched {disp} "
          f"(padded fraction {pad:.3f}) | "
          f"jit dispatches {ce('jit_dispatches')} over "
          f"{ce('steps_dispatched')} steps")
    kv_prefixes = ["kv." if n == "engine" else f"kv.{n}." for n in
                   engine_names]
    swap_out = [m.get(p + "swap_bytes_out") for p in kv_prefixes]
    if any(g is not None for g in swap_out):
        tot_out = sum(int(g.value) for g in swap_out if g is not None)
        tot_in = sum(int(g.value) for g in
                     (m.get(p + "swap_bytes_in") for p in kv_prefixes)
                     if g is not None)
        print(f"[serve] kv: swap out {tot_out}B in {tot_in}B | "
              f"zombies reaped {c('rm.zombies_reaped')} "
              f"recovered {c('rm.recoveries')}")
    rec = obs.recorder
    if rec.enabled:
        print(f"[serve] trace: {rec.recorded} events recorded, "
              f"{rec.dropped} dropped (capacity {rec.capacity})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device for the weights and every engine "
                         "(default cuda; raises without a card, so only "
                         "--device cpu runs on the host)")
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--turns", type=int, default=9)
    ap.add_argument("--lanes", type=int, default=2,
                    help="dispatcher lanes for the dense engine; ignored "
                         "under --paged (lanes = --max-batch there)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--paged", action="store_true",
                    help="paged megastep engine + fused dispatcher")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="paged decode batch width (rows per megastep)")
    ap.add_argument("--num-blocks", type=int, default=129)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=0,
                    help="stall-free per-step token budget (0 = fixed "
                         "chunk); must be >= --max-batch")
    ap.add_argument("--mesh", default=None, metavar="tp=N",
                    help="shard the megastep tensor-parallel over N "
                         "devices (requires --paged; N must divide the "
                         "model's KV-head count)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable the flight recorder and export a Chrome "
                         "trace-event JSON here on exit (Perfetto-loadable)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the unified metrics registry snapshot "
                         "(JSON) here on exit")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="flight-recorder ring capacity in events "
                         "(drop-oldest beyond this)")
    ap.add_argument("--turn-timeout", type=float, default=300.0,
                    help="seconds to wait for each turn's result; on "
                         "expiry the turn is aborted ENGINE-SIDE (its KV "
                         "blocks released) instead of being orphaned")
    ap.add_argument("--step-deadline", type=float, default=0.0,
                    help="watchdog deadline for one engine step (seconds, "
                         "0 = off): a hung megastep becomes a typed "
                         "StepTimeoutError instead of a frozen dispatcher")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="write-ahead session journal directory (requires "
                         "--paged): committed turns survive an engine "
                         "crash and restore bit-exactly after rebuild")
    ap.add_argument("--fleet", type=int, default=1, metavar="N",
                    help="run N paged engines behind the elastic fleet "
                         "router (requires --paged; lanes = N * "
                         "--max-batch)")
    ap.add_argument("--kill", type=int, default=None, metavar="IDX",
                    help="kill engine IDX after the first completed turn "
                         "(requires --fleet >= 2): in-flight turns fail "
                         "typed and are resubmitted to the survivors")
    ap.add_argument("--drain", type=int, default=None, metavar="IDX",
                    help="gracefully drain engine IDX after the first "
                         "completed turn (requires --fleet >= 2): its "
                         "sessions migrate off, no turn fails")
    ap.add_argument("--spill-dir", default=None, metavar="DIR",
                    help="disk spill tier below the host-RAM KV swap "
                         "store (requires --paged; crc32-checked on "
                         "read-back)")
    ap.add_argument("--spill-capacity-mb", type=int, default=64,
                    help="host-RAM swap tier capacity before LRU "
                         "writeback to --spill-dir (default 64)")
    ap.add_argument("--autopilot", action="store_true",
                    help="closed-loop overload autopilot (requires "
                         "--paged): retunes the megastep token budget "
                         "within its pre-traced buckets and walks the "
                         "brownout ladder (hibernate -> rebalance -> "
                         "shed) on SLO breach, recovering rung by rung")
    ap.add_argument("--slo-ttft-p95", type=float, default=2.0,
                    metavar="SEC",
                    help="autopilot TTFT p95 SLO in seconds "
                         "(default 2.0; requires --autopilot)")
    ap.add_argument("--slo-itl-p95", type=float, default=0.5,
                    metavar="SEC",
                    help="autopilot inter-token-latency p95 SLO in "
                         "seconds (default 0.5; requires --autopilot)")
    args = ap.parse_args(argv)
    if args.turn_timeout <= 0:
        raise SystemExit("invalid --turn-timeout: must be > 0 seconds")
    if args.step_deadline < 0:
        raise SystemExit("invalid --step-deadline: must be >= 0 seconds")
    if args.journal_dir and not args.paged:
        raise SystemExit("--journal-dir requires --paged (only paged "
                         "sessions export KV pages for the journal)")
    if args.fleet < 1:
        raise SystemExit("invalid --fleet: need at least one engine")
    if args.fleet > 1 and not args.paged:
        raise SystemExit("--fleet requires --paged (only paged sessions "
                         "export KV pages, which is how they migrate)")
    if args.spill_dir and not args.paged:
        raise SystemExit("--spill-dir requires --paged (the dense engine "
                         "has no KV swap store to tier)")
    if args.spill_capacity_mb <= 0:
        raise SystemExit("invalid --spill-capacity-mb: must be > 0")
    for flag, idx in (("--kill", args.kill), ("--drain", args.drain)):
        if idx is None:
            continue
        if args.fleet < 2:
            raise SystemExit(f"{flag} requires --fleet >= 2: refusing to "
                             f"take down the only engine")
        if not 0 <= idx < args.fleet:
            raise SystemExit(f"invalid {flag}: engine {idx} does not "
                             f"exist (fleet has engines 0..{args.fleet-1})")
    if args.kill is not None and args.kill == args.drain:
        raise SystemExit("--kill and --drain name the same engine; "
                         "pick one fate for it")
    if args.autopilot and not args.paged:
        raise SystemExit("--autopilot requires --paged (only the fused "
                         "dispatcher runs the SLO control loop)")
    if args.slo_ttft_p95 <= 0 or args.slo_itl_p95 <= 0:
        raise SystemExit("invalid SLO: --slo-ttft-p95 and --slo-itl-p95 "
                         "must be > 0 seconds")

    obs = build_obs(args)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(remat=False)
    params = build(cfg).init_params(seed=0, device=args.device)
    engine, backend = build_backend(cfg, params, args, obs=obs)
    fleet = backend if isinstance(backend, FleetBackend) else None
    lanes = args.max_batch * args.fleet if args.paged else args.lanes
    ap_cfg = None
    if args.autopilot:
        from repro_torch.serving.autopilot import AutopilotConfig
        ap_cfg = AutopilotConfig(slo_ttft_p95_s=args.slo_ttft_p95,
                                 slo_itl_p95_s=args.slo_itl_p95)
    rm = AgentRM(backend,
                 AgentRMConfig(lanes=lanes, detect_after_s=20.0,
                               step_deadline_s=args.step_deadline or None,
                               autopilot=ap_cfg),
                 obs=obs)

    t0 = time.time()
    handles = []
    for i in range(args.turns):
        agent = f"agent-{i % args.agents}"
        qc = (QueueClass.INTERACTIVE, QueueClass.SUBAGENT,
              QueueClass.BACKGROUND)[i % 3]
        prompt = f"turn {i}: do the thing"
        handles.append((agent, prompt,
                        rm.submit(agent, prompt, queue_class=qc)))
    lat = []
    timed_out = failed_over = shed = 0
    kill_pending, drain_pending = args.kill, args.drain
    for agent, prompt, h in handles:
        try:
            out = h.result(timeout=args.turn_timeout)
        except BackpressureError as e:
            # overload autopilot shed this admission: back off for the
            # advertised retry_after and resubmit once (clients own the
            # retry; the ladder guarantees the hint is finite)
            shed += 1
            print(f"[serve] {agent} -> SHED by overload autopilot "
                  f"(retry after {e.retry_after_s:.2f}s); resubmitting")
            time.sleep(e.retry_after_s)
            h = rm.submit(agent, prompt)
            try:
                out = h.result(timeout=args.turn_timeout)
            except BackpressureError:
                print(f"[serve] {agent} -> still shedding; giving up "
                      f"this turn")
                continue
        except TimeoutError:
            # abort the turn engine-side so its KV blocks are released —
            # then wait briefly for the dispatcher to apply the abort
            rm.cancel(h.turn.tid, reason="exceeded --turn-timeout")
            try:
                h.result(timeout=30)
            except TurnCancelled:
                pass
            timed_out += 1
            print(f"[serve] {agent} -> TIMED OUT after "
                  f"{args.turn_timeout:.0f}s (turn aborted, blocks freed)")
            continue
        except EngineLostError as e:
            # typed failure from the killed engine: resubmit — the shared
            # journal restores the session bit-exactly on a survivor
            print(f"[serve] {agent} -> ENGINE LOST mid-turn ({e}); "
                  f"resubmitting to the survivors")
            h = rm.submit(agent, prompt)
            out = h.result(timeout=args.turn_timeout)
            failed_over += 1
        lat.append(h.turn.end - h.turn.arrival)
        print(f"[serve] {agent} -> {out[:48]}  ({lat[-1]*1000:.0f} ms)")
        if kill_pending is not None:
            # first turn is home: now take an engine down mid-traffic
            fleet.kill_engine(kill_pending)
            print(f"[serve] === killed engine{kill_pending} with "
                  f"{args.turns - len(lat)} turns still in flight ===")
            kill_pending = None
        if drain_pending is not None:
            fleet.drain(drain_pending)
            print(f"[serve] === draining engine{drain_pending} "
                  f"(sessions migrating off, no turn fails) ===")
            drain_pending = None
    snap = rm.monitor.snapshot()
    lat.sort()
    pct = (f"p50 {lat[len(lat)//2]*1000:.0f}ms "
           f"p95 {lat[int(0.95*(len(lat)-1))]*1000:.0f}ms"
           if lat else f"all {timed_out} timed out")
    print(f"[serve] {args.turns} turns in {time.time()-t0:.1f}s | "
          f"{pct} | reaped {snap.zombies_reaped} "
          f"recovered {snap.recoveries}")
    if args.paged and fleet is None:
        st = engine.step_stats()
        print(f"[serve] megastep: {st['jit_dispatches_per_step']:.2f} "
              f"dispatches/step, padded_token_fraction "
              f"{st['padded_token_fraction']:.3f}, trace buckets "
              f"{st['trace_buckets']} (set {st['bucket_set']}), "
              f"tp={st['tp']}, host transfer "
              f"{st['host_transfer_bytes_per_step']}B/step")
    if fleet is not None:
        fs = fleet.fleet_stats()
        for name, st in fs["engines"].items():
            total = st["blocks_in_use"] + st["blocks_free"]
            print(f"[serve] {name}: {st['state']}, "
                  f"{st['sessions']} sessions, "
                  f"blocks {st['blocks_in_use']}/{total}")
        print(f"[serve] fleet: {fs['engines_active']} active | "
              f"lost {fs['engines_lost']} drained {fs['engines_drained']} "
              f"| migrations sudden {fs['migrations_sudden']} "
              f"fluid {fs['migrations_fluid']} "
              f"aborted {fs['migrations_aborted']} "
              f"(pages streamed {fs['pages_streamed']}) | "
              f"sessions failed over {fs['sessions_failed_over']}"
              + (f" | turns resubmitted {failed_over}" if failed_over
                 else ""))
    if rm.autopilot is not None:
        st = rm.autopilot.stats()
        print(f"[serve] autopilot: rung {st['rung']} "
              f"(severity {st['severity']}/{st['max_severity']}) | "
              f"escalations {st['escalations']} "
              f"relaxations {st['relaxations']} | "
              f"shed {shed} turn(s) client-side")
    for agent_id, clm in rm.clm.items():
        print(f"[serve] {agent_id}: ctx={clm.window_tokens} tok, "
              f"psi='{clm.psi_message()[:64]}...'")
    rm.shutdown()
    # wait for the middleware's daemon threads to see the stop: with torch
    # loaded, one still waiting when the interpreter finalizes aborts the
    # process ("terminate called without an active exception", exit 134)
    for t in (rm._dispatcher, rm._reaper):
        t.join(timeout=10)
    if args.paged:
        # publish kv.* gauges for the summary/dump (every live engine)
        if fleet is not None:
            for mem in fleet.members:
                if mem.alive:
                    mem.backend.engine.kv_stats()
        else:
            engine.kv_stats()
    names = ([m.backend.engine.name for m in fleet.members]
             if fleet is not None else ["engine"])
    print_obs_summary(obs, engine_names=names)
    if args.trace_out:
        obs.recorder.export_chrome(args.trace_out)
        print(f"[serve] chrome trace -> {args.trace_out}")
    if args.metrics_dump:
        obs.metrics.dump_json(args.metrics_dump)
        print(f"[serve] metrics snapshot -> {args.metrics_dump}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
