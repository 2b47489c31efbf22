"""The chaos scenarios of ``tests/test_chaos.py`` on the port's engine.

Fault injection (``repro_torch.faults``), the journal
(``repro_torch.serving.journal``) and the middleware's retry, watchdog,
rebuild and KV-pressure paths, over the port's ``PagedInferenceEngine`` on
the CPU at float32 on gemma-2b smoke: blast-radius isolation for a poisoned
row, transient-fault retry, the watchdog, KV-pressure degradation, swap
corruption caught and restored from the journal, crash-safe recovery, the
rebuild's purge of the dead generation, and a seeded mini soak. Where a
scenario yields tokens (the empty plan, crash and restore), the port's
tokens equal the JAX engine's with converted weights. The subprocess soak
(``test_full_chaos_soak_in_subprocess``) drives the reference's benchmark
and has no counterpart here."""
import time

import jax
import numpy as np
import pytest

import repro.core
import repro.serving
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build
from repro.serving import PagedEngineBackend as JaxBackend
from repro.serving import PagedInferenceEngine as JaxEngine
import repro_torch.core
import repro_torch.serving
from repro_torch.configs import get_smoke_config
from repro_torch.core import AgentRM, AgentRMConfig, StepReport, \
    SteppableBackend
from repro_torch.faults import (ChaosBackend, FaultPlan, FaultSpec,
                                FaultyKVSwapStore)
from repro_torch.serving import (EngineError, PagedEngineBackend,
                                 PagedInferenceEngine, PoisonedRowError,
                                 SessionJournal, StepTimeoutError,
                                 TransientStepError)
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("gemma-2b").replace(remat=False,
                                         compute_dtype="float32")
    cfg = get_smoke_config("gemma-2b").replace(remat=False,
                                               compute_dtype="float32")
    jparams = build(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, jcfg, jparams


def _kw(kw):
    kw.setdefault("num_blocks", 40)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 96)
    return kw


def _paged(cfg, params, **kw):
    return PagedInferenceEngine(cfg, params, device="cpu", **_kw(kw))


def _jax_paged(setup, **kw):
    return JaxEngine(setup[2], setup[3], **_kw(kw))


def _drive(be, agents, max_steps=400):
    """Drive a backend directly (no middleware): begin one turn per agent,
    step until all finish, collect. Returns {agent: text} for successes and
    {agent: error} for typed failures."""
    rids = {be.begin_turn(a, "", p): a for a, p in agents.items()}
    outs, errs = {}, {}
    for _ in range(max_steps):
        if not rids:
            break
        rep = be.step()
        for rid, err in rep.failed:
            if rid in rids:
                errs[rids.pop(rid)] = err
        for rid in rep.finished:
            if rid in rids:
                outs[rids.pop(rid)] = be.collect(rid)
    assert not rids, f"turns never finished: {rids}"
    return outs, errs


# ------------------------------------------------ fault-free transparency

def test_chaos_backend_with_empty_plan_is_bitwise_noop(setup):
    """The wrapped backend with an empty fault plan gives the bare one's
    tokens, and those equal the JAX engine's."""
    cfg, params = setup[:2]
    agents = {f"a{i}": f"prompt number {i} " * 2 for i in range(3)}
    ref, _ = _drive(PagedEngineBackend(_paged(cfg, params),
                                       max_new_tokens=6), agents)
    chaos = ChaosBackend(PagedEngineBackend(_paged(cfg, params),
                                            max_new_tokens=6), FaultPlan())
    got, errs = _drive(chaos, agents)
    assert not errs and got == ref
    assert all(v == 0 for v in chaos.injected.values())
    want, _ = _drive(JaxBackend(_jax_paged(setup), max_new_tokens=6), agents)
    assert got == want


# ------------------------------------------------- poisoned-row isolation

def test_poisoned_row_fails_only_its_own_turn(setup):
    """A NaN-poisoned row surfaces as a typed ``PoisonedRowError`` for
    exactly its own turn while every batchmate's tokens match the
    fault-free run bit for bit."""
    cfg, params = setup[:2]
    prompts = {"victim": "doomed prompt " * 2,
               "mate1": "innocent bystander one",
               "mate2": "innocent bystander two"}
    ref, _ = _drive(PagedEngineBackend(_paged(cfg, params),
                                       max_new_tokens=8), prompts)

    eng = _paged(cfg, params)
    be = PagedEngineBackend(eng, max_new_tokens=8)
    rids = {be.begin_turn(a, "", p): a for a, p in prompts.items()}
    victim_rid = next(r for r, a in rids.items() if a == "victim")
    outs, errs = {}, {}
    for step in range(200):
        if step == 2:
            eng.inject_poison(victim_rid)
        if not rids:
            break
        rep = be.step()
        for rid, err in rep.failed:
            errs[rids.pop(rid)] = err
        for rid in rep.finished:
            outs[rids.pop(rid)] = be.collect(rid)
    assert isinstance(errs.pop("victim"), PoisonedRowError)
    assert not errs
    assert outs == {a: ref[a] for a in ("mate1", "mate2")}
    assert eng.obs.metrics.counter("engine.poisoned_rows").value == 1
    for rid in list(eng.reqs):
        eng.release(rid)
    assert eng.cache.allocator.num_used == 0


# --------------------------------------------- retry / watchdog scaffolds

class _Scripted(SteppableBackend):
    """Minimal in-memory backend: one token of service per step per turn,
    finishing after ``need`` tokens."""

    def __init__(self, need=3):
        self.need = need
        self.turns = {}
        self._rid = 0

    def begin_turn(self, agent_id, context, prompt):
        self._rid += 1
        self.turns[self._rid] = 0
        return self._rid

    def can_admit(self, agent_id, prompt):
        return True

    def collect(self, rid):
        return "done"

    def abort_turn(self, rid):
        self.turns.pop(rid, None)

    def park_turn(self, rid):
        pass

    def resume_turn(self, rid):
        pass

    def step(self):
        fins = []
        for rid in list(self.turns):
            self.turns[rid] += 1
            if self.turns[rid] >= self.need:
                del self.turns[rid]
                fins.append(rid)
        return StepReport(serviced={r: 1 for r in self.turns},
                          finished=fins, failed=[], waiting=[])


def test_transient_fault_retries_in_place_without_rebuild():
    class Flaky(_Scripted):
        def __init__(self):
            super().__init__()
            self.boom = 2

        def step(self):
            if self.boom:
                self.boom -= 1
                raise TransientStepError("injected transient")
            return super().step()

    rm = AgentRM(Flaky(), AgentRMConfig(
        lanes=1, step_backoff_s=0.01, rebuild_after_failures=5))
    try:
        assert rm.submit("a", "p").result(10) == "done"
        m = rm.obs.metrics
        assert m.counter("rm.step_retries").value == 2
        assert m.counter("rm.engine_rebuilds").value == 0
    finally:
        rm.shutdown()


def test_watchdog_converts_hung_step_into_typed_failure():
    class HangsOnce(_Scripted):
        def __init__(self):
            super().__init__()
            self.hang = True

        def step(self):
            if self.hang:
                self.hang = False
                time.sleep(1.5)
                return StepReport({}, [], [], [])
            return super().step()

    rm = AgentRM(HangsOnce(), AgentRMConfig(
        lanes=1, step_deadline_s=0.2, step_backoff_s=0.01))
    try:
        h1 = rm.submit("a", "p")
        with pytest.raises(StepTimeoutError):
            h1.result(10)
        assert rm.submit("b", "q").result(10) == "done"
        assert rm.obs.metrics.counter("rm.step_timeouts").value == 1
    finally:
        rm.shutdown()


# ------------------------------------ failed turns leak nothing, typed

def test_failed_turn_releases_blocks_and_handle_reraises_typed(setup):
    cfg, params = setup[:2]
    eng = _paged(cfg, params, max_batch=2)
    be = PagedEngineBackend(eng, max_new_tokens=16)
    rm = AgentRM(be, AgentRMConfig(lanes=2, detect_after_s=60.0))
    try:
        h1 = rm.submit("pa", "poison me " * 2)
        h2 = rm.submit("pb", "leave me alone")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rid = be.sessions.get("pa")
            if rid is not None and rid in eng.active:
                eng.inject_poison(rid)
                break
            time.sleep(0.005)
        else:
            pytest.fail("pa never became active")
        with pytest.raises(PoisonedRowError):
            h1.result(60)
        assert h2.result(60).startswith("tok:")
        assert isinstance(h1._error, EngineError)
    finally:
        rm.shutdown()
    live = sum(r.table.num_pages for r in eng.reqs.values()
               if r.table is not None)
    assert eng.cache.allocator.num_used == live
    for rid in list(eng.reqs):
        eng.release(rid)
    assert eng.cache.allocator.num_used == 0


# -------------------------------------------- KV-pressure degradation

def test_kv_pressure_hibernates_victim_instead_of_stalling(setup):
    """With the pool too small for two resident sessions, admission parks
    the MLFQ-lowest running victim instead of stalling; both turns
    complete."""
    cfg, params = setup[:2]
    eng = _paged(cfg, params, num_blocks=9, block_size=8, max_batch=2,
                 max_len=96, prefill_chunk=48)
    be = PagedEngineBackend(eng, max_new_tokens=24)
    rm = AgentRM(be, AgentRMConfig(
        lanes=2, detect_after_s=60.0, quantum_tokens=(1e9, 1e9, 1e9),
        allotment_tokens=(float("inf"),) * 3))
    try:
        h1 = rm.submit("hog", "x" * 40)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rid = be.sessions.get("hog")
            if rid is not None and rid in eng.active:
                break
            time.sleep(0.005)
        h2 = rm.submit("late", "y" * 33)
        assert h1.result(120).startswith("tok:")
        assert h2.result(120).startswith("tok:")
        assert rm.obs.metrics.counter("rm.kv_degradations").value >= 1
    finally:
        rm.shutdown()


# ------------------------------------------- swap corruption + journal

def test_swap_corruption_detected_and_session_restored_from_journal(
        setup, tmp_path):
    """Bytes flipped in the swap tier are caught by the checksum at wake;
    the next turn restores the session from the journal bit-exactly."""
    cfg, params = setup[:2]
    prompts = {"ag": "hello swap tier"}

    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6)
    ref1, _ = _drive(ref_be, prompts)
    ref2, _ = _drive(ref_be, {"ag": "second turn prompt"})

    store = FaultyKVSwapStore()
    journal = SessionJournal(str(tmp_path / "journal"))
    eng = _paged(cfg, params, swap_store=store)
    be = PagedEngineBackend(eng, max_new_tokens=6, journal=journal)
    out1, _ = _drive(be, prompts)
    assert out1 == ref1

    be.hibernate_session("ag")
    assert store.corrupt_one() is not None
    be.wake_session("ag")
    assert eng.swap.corruptions_detected == 1
    assert "ag" not in be.sessions

    out2, errs = _drive(be, {"ag": "second turn prompt"})
    assert not errs and out2 == ref2
    assert eng.cache.allocator.num_used == sum(
        r.table.num_pages for r in eng.reqs.values() if r.table is not None)


# --------------------------------------------- crash-safe recovery

def _crash_run(core, serving, make_engine, journal_dir, crash: bool):
    """Two turns per agent through ``core.AgentRM`` over
    ``serving.PagedEngineBackend`` (either package's); with ``crash`` an
    engine crash lands a few steps into the second turns."""
    t1 = {a: f"first turn for {a}" for a in ("ca", "cb")}
    t2 = {a: f"second turn for {a}" for a in ("ca", "cb")}
    journal = serving.SessionJournal(journal_dir)
    inner = serving.PagedEngineBackend(make_engine(), max_new_tokens=6,
                                       journal=journal,
                                       engine_factory=make_engine)
    be = ChaosBackend(inner, FaultPlan()) if crash else inner
    rm = core.AgentRM(be, core.AgentRMConfig(lanes=2, detect_after_s=60.0,
                                             step_backoff_s=0.01))
    try:
        r1 = {a: rm.submit(a, p).result(120) for a, p in t1.items()}
        if crash:
            be.plan = FaultPlan([FaultSpec(be.step_idx + 5, "crash")])
        hs = {a: rm.submit(a, p) for a, p in t2.items()}
        r2 = {a: h.result(120) for a, h in hs.items()}
        return r1, r2, rm.obs.metrics, be
    finally:
        rm.shutdown()


def test_crash_mid_decode_recovers_sessions_bit_exact(setup, tmp_path):
    """An injected engine crash mid-turn tears the engine down; every live
    session restores from the journal and the in-flight turn replays: the
    outputs equal the fault-free run's and the JAX stack's."""
    cfg, params = setup[:2]

    def factory():
        return _paged(cfg, params, max_batch=2)

    ref1, ref2, _, _ = _crash_run(repro_torch.core, repro_torch.serving,
                                  factory, str(tmp_path / "ref"),
                                  crash=False)
    got1, got2, metrics, chaos = _crash_run(
        repro_torch.core, repro_torch.serving, factory,
        str(tmp_path / "crash"), crash=True)
    assert got1 == ref1
    assert got2 == ref2
    assert chaos.injected["crash"] == 1
    assert metrics.counter("rm.engine_rebuilds").value == 1

    def jax_factory():
        return _jax_paged(setup, max_batch=2)

    want1, want2, _, _ = _crash_run(repro.core, repro.serving, jax_factory,
                                    str(tmp_path / "jax"), crash=False)
    assert (got1, got2) == (want1, want2)


def test_rebuild_purges_dead_generation_from_shared_swap_store(setup,
                                                               tmp_path):
    cfg, params = setup[:2]
    store = FaultyKVSwapStore()
    journal = SessionJournal(str(tmp_path / "jshare"))

    def factory():
        return _paged(cfg, params, max_batch=2, swap_store=store)

    be = PagedEngineBackend(factory(), max_new_tokens=6,
                            journal=journal, engine_factory=factory)
    outs, errs = _drive(be, {"sa": "turn a", "sb": "turn b"})
    assert not errs
    be.hibernate_session("sa")
    be.hibernate_session("sb")
    assert len(store) == 2
    assert be.rebuild()
    assert len(store) == 2
    outs2, errs2 = _drive(be, {"sa": "turn a2", "sb": "turn b2"})
    assert not errs2 and set(outs2) == {"sa", "sb"}


# --------------------------------------------------- mini chaos soak

def test_mini_chaos_soak_no_hangs_no_leaks_typed_failures_only(setup,
                                                               tmp_path):
    """A seeded fault plan over a multi-agent multi-turn run: every turn
    resolves, every failure is a typed ``EngineError``, no session is lost,
    and no KV block leaks once sessions are released."""
    cfg, params = setup[:2]
    journal = SessionJournal(str(tmp_path / "soak-journal"))
    store = FaultyKVSwapStore()

    def factory():
        return _paged(cfg, params, num_blocks=60, max_batch=4,
                      swap_store=store)

    inner = PagedEngineBackend(factory(), max_new_tokens=6,
                               journal=journal, engine_factory=factory)
    chaos = ChaosBackend(inner, FaultPlan.generate(
        seed=7, n_steps=400,
        rates={"step_exception": 0.05, "poison_row": 0.04, "crash": 0.01,
               "kv_squat": 0.03, "rate_limit": 0.03, "step_hang": 0.0,
               "swap_write_error": 0.02, "swap_read_error": 0.02,
               "swap_corrupt": 0.02}), store=store)
    rm = AgentRM(chaos, AgentRMConfig(lanes=4, detect_after_s=60.0,
                                      step_backoff_s=0.01,
                                      step_deadline_s=15.0))
    chaos.on_rate_limit = rm.report_rate_limited
    agents = [f"s{i}" for i in range(5)]
    failures = []
    try:
        for turn in range(3):
            hs = [(a, rm.submit(a, f"turn {turn} agent {a}"))
                  for a in agents]
            for a, h in hs:
                try:
                    assert h.result(180).startswith("tok:")
                except EngineError as e:
                    failures.append((a, e))
        chaos.plan = FaultPlan()
        probes = [(a, rm.submit(a, f"probe {a}")) for a in agents]
        for a, h in probes:
            assert h.result(180).startswith("tok:"), f"session lost: {a}"
        assert rm.monitor.snapshot().zombies_reaped == 0
        if chaos.injected["rate_limit"]:
            assert rm.obs.metrics.counter(
                "rm.rate_limit_events").value >= 1
    finally:
        rm.shutdown()
    chaos.release_squat()
    eng = inner.engine
    live = sum(r.table.num_pages for r in eng.reqs.values()
               if r.table is not None)
    assert eng.cache.allocator.num_used <= live
    for rid in list(eng.reqs):
        eng.release(rid)
    assert eng.cache.allocator.num_used == 0
