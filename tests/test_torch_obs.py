"""The port's flight recorder over the fused stack on the CPU: the
megastep's host phases (one span each per work step, in order, inside the
step's ``engine.megastep`` span), the dispatcher's pass spans beside them,
MLFQ preemptions as a counter and the turns' wait episodes, the recorder's
epoch clock and Chrome export, and a recorder that is off reading no clock
and recording nothing. AgentRM runs fused over ``PagedEngineBackend`` on
gemma-2b smoke."""
import time

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core import AgentRM, AgentRMConfig
from repro_torch.models import transformer
from repro_torch.obs import (FlightRecorder, Observability, TraceConfig,
                             validate_chrome)
from repro_torch.serving import (PagedEngineBackend, PagedInferenceEngine,
                                 graphs)
from repro_torch.serving.paging.engine import PHASES

KW = dict(num_blocks=129, block_size=8, max_batch=2, max_len=128,
          token_budget=16)
ENGINE_PHASES = tuple(f"engine.{p}" for p in PHASES)
SCHED_SPANS = ("sched.pass", "sched.charge", "sched.wait")


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("gemma-2b").replace(remat=False,
                                               compute_dtype="float32")
    return cfg, transformer.init_params(cfg, seed=0, device="cpu")


def _engine(model, trace=True, staged=False):
    obs = Observability(TraceConfig(enabled=trace, capacity=1 << 16))
    eng = PagedInferenceEngine(model[0], model[1], device="cpu", obs=obs,
                               **KW)
    if staged:
        eng.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    return eng


def _serve(eng, agents=3, turns=2, new_tokens=6, **rm_kw):
    """Every agent's turns through a fused AgentRM; the stack's handles."""
    rm = AgentRM(PagedEngineBackend(eng, max_new_tokens=new_tokens),
                 AgentRMConfig(detect_after_s=60.0, **rm_kw))
    try:
        for k in range(turns):
            hs = [rm.submit(f"agent{i}", f"turn {k} of agent {i} " * (i + 1))
                  for i in range(agents)]
            for h in hs:
                h.result(120)
    finally:
        rm.shutdown()
        rm._dispatcher.join(30)
    return rm


def _by_name(events, names):
    return [e for e in events if e["name"] in names]


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_each_work_step_has_every_phase_once_in_order(model, staged):
    eng = _engine(model, staged=staged)
    _serve(eng, lanes=2)
    evs = eng.obs.recorder.events()
    assert eng.obs.recorder.dropped == 0
    steps = _by_name(evs, {"engine.megastep"})
    assert len(steps) == eng.steps_dispatched > 0
    phases = {}
    for e in _by_name(evs, set(ENGINE_PHASES)):
        phases.setdefault(e["args"]["seq"], []).append(e)
    assert len({s["args"]["seq"] for s in steps}) == len(steps)
    for s in steps:
        got = sorted(phases[s["args"]["seq"]], key=lambda e: e["ts"])
        assert [e["name"] for e in got] == list(ENGINE_PHASES)
        admit, inner = got[0], got[1:]
        # admission ends where the step's span begins; pack .. bookkeep
        # tile the step's span, each starting where the last ended
        assert admit["ts"] + admit["dur"] == pytest.approx(s["ts"], abs=1e-9)
        ends = [s["ts"]] + [e["ts"] + e["dur"] for e in inner]
        assert [e["ts"] for e in inner] == pytest.approx(ends[:-1], abs=1e-9)
        assert ends[-1] == pytest.approx(s["ts"] + s["dur"], abs=1e-9)
        for e in got:
            assert e["track"] == "megastep"
            assert (e["args"]["C"], e["args"]["rows"]) == (
                s["args"]["C"], s["args"]["rows"])


def test_dispatcher_spans_never_overlap_the_engines(model):
    eng = _engine(model)
    _serve(eng, lanes=2)
    evs = eng.obs.recorder.events()
    sched = _by_name(evs, set(SCHED_SPANS))
    engine = _by_name(evs, set(ENGINE_PHASES) | {"engine.megastep"})
    assert {e["name"] for e in sched} >= {"sched.pass", "sched.charge"}
    assert all(e["track"] == "dispatcher" for e in sched)
    spans = sorted([(e["ts"], e["ts"] + e["dur"], "sched") for e in sched]
                   + [(e["ts"], e["ts"] + e["dur"], "engine")
                      for e in engine])
    # one thread: every dispatcher span ends before the next engine span
    # starts, and the other way round
    for (a0, a1, k0), (b0, b1, k1) in zip(spans, spans[1:]):
        if k0 != k1:
            assert a1 <= b0 + 1e-9, (a0, a1, k0, b0, b1, k1)


def test_preemptions_counted_and_each_wait_episode_summed(model):
    # two lanes, four agents, a 2-token quantum: long turns are parked
    eng = _engine(model)
    rm = _serve(eng, agents=4, turns=1, new_tokens=10, lanes=2,
                quantum_tokens=(2.0, 4.0, 8.0),
                allotment_tokens=(4.0, 16.0, float("inf")))
    evs = eng.obs.recorder.events()
    preempted = _by_name(evs, {"sched.preempted"})
    count = rm.obs.metrics.counter("rm.preemptions").value
    assert count == len(preempted) > 0
    by_tid = {}
    for e in preempted:
        by_tid[int(e["args"]["tid"])] = by_tid.get(int(e["args"]["tid"]),
                                                   0) + 1
    for tid, n in by_tid.items():
        admitted = [e for e in _by_name(evs, {"sched.admitted"})
                    if int(e["args"]["tid"]) == tid]
        started = [e for e in _by_name(evs, {"sched.started"})
                   if int(e["args"]["tid"]) == tid]
        # one admission a queued episode: the first, then one a preemption
        assert len(admitted) == len(started) == n + 1
        assert [e["args"]["resumed"] for e in started] == [0.0] + [1.0] * n
        assert len({e["args"]["rid"] for e in started}) == 1
        # the episodes' waits sum to the turn's time queued (the
        # scheduler's own clock, read once a pass)
        turn = rm.handles[tid].turn
        assert sum(e["args"]["wait_s"] for e in admitted) == pytest.approx(
            turn.queue_wait, abs=0.02 * (n + 1))


def test_epoch_clock_and_chrome_export():
    rec = FlightRecorder(TraceConfig(enabled=True, capacity=64))
    t = rec.now()
    assert abs(rec.epoch_ns(t) - time.time_ns()) < 50e6
    assert rec.epoch_ns(t + 1.5) - rec.epoch_ns(t) == 1_500_000_000
    ev = rec.name("phase", ("seq",))
    tr = rec.track("megastep", group="engine")
    rec.interval(ev, tr, t, t + 0.002, 7)
    rec.instant(rec.name("tick"), tr)
    got = rec.events()[0]
    assert (got["ts"], got["dur"], got["args"]) == (t, pytest.approx(0.002),
                                                    {"seq": 7.0})
    obj = rec.chrome()
    assert validate_chrome(obj) == []
    assert obj["otherData"]["clock_domain"].startswith("unix_epoch_us")
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert xs[0]["ts"] == pytest.approx(rec.epoch_ns(t) / 1e3, abs=1.0)
    assert xs[0]["dur"] == pytest.approx(2000.0)
    anchor = rec._epoch
    rec.reset()
    assert rec._epoch != anchor and rec.recorded == 0


def test_a_recorder_that_is_off_reads_no_clock_and_records_nothing(
        model, monkeypatch):
    eng = _engine(model, trace=False)
    be = PagedEngineBackend(eng, max_new_tokens=8)
    for i in range(2):
        be.begin_turn(f"agent{i}", "", f"prompt of agent {i}")
    while eng._queue or any(r.prefilling for r in eng.active.values()):
        eng.step()
    rec = eng.obs.recorder
    calls = {"clock": 0, "recorder": 0}
    real = time.perf_counter

    def clock():
        calls["clock"] += 1
        return real()

    def recorded(*a, **k):
        calls["recorder"] += 1
    monkeypatch.setattr(time, "perf_counter", clock)
    for meth in ("instant", "complete", "interval"):
        monkeypatch.setattr(rec, meth, recorded)
    assert len(eng.active) == 2 and not eng._queue
    eng.step()                                  # one decode step, two rows
    # what the engine read before it had phase spans: the step's start and
    # end, and its histogram's window stamp; a sampled token's stamp, and
    # its histogram's window stamp
    assert calls == {"clock": 3 + 2 * 2, "recorder": 0}


def test_a_pass_with_the_recorder_off_records_nothing(model, monkeypatch):
    eng = _engine(model, trace=False)
    calls = []
    for meth in ("instant", "complete", "interval"):
        monkeypatch.setattr(eng.obs.recorder, meth,
                            lambda *a, _m=meth, **k: calls.append(_m))
    rm = _serve(eng, agents=3, turns=1, new_tokens=6, lanes=2,
                quantum_tokens=(2.0, 4.0, 8.0),
                allotment_tokens=(4.0, 16.0, float("inf")))
    assert rm.obs.metrics.counter("rm.preemptions").value > 0
    assert calls == []
