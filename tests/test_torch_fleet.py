"""The elastic-fleet scenarios of ``tests/test_fleet.py`` on the port.

``repro_torch.distributed.elastic.FleetBackend`` over the port's
``PagedEngineBackend``s on the CPU, float32 on gemma-2b smoke unless a test
says bf16: the journal restore across differing engines, live migration
(sudden and fluid, and a fluid one interrupted), engine-loss failover, the
rebalance hook, victim selection, graceful drain, the disk tier below the
host-RAM swap store, the fleet fault kinds, and the reference's TP2-to-TP4
failover: a session journaled under a tp 2 mesh restores on a tp 4
survivor (``tests/test_torch_sharded.py``'s model and schedule).

A mixed fleet holds one JAX member and one port member with converted
weights: a session moves each way, suddenly between turns and fluidly
mid-decode, and its tokens equal a JAX-only engine's. The port's
``reshard_params`` and ``elastic_restore`` place a tree on one device
and raise on a mesh of several: that placement takes the training rules,
a later slice of the port."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build
from repro.serving import PagedEngineBackend as JaxBackend
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import (FleetBackend, elastic_restore,
                                             reshard_params)
from repro_torch.faults import ChaosBackend, FaultPlan, FaultSpec
from repro_torch.faults.plan import FAULT_KINDS
from repro_torch.serving import (DiskTierKVSwapStore, EngineLostError,
                                 MigrationError, PagedEngineBackend,
                                 PagedInferenceEngine, SessionJournal,
                                 SwapCorruptionError)
from repro_torch.launch.mesh import make_local_mesh, make_tp_mesh
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax


def _models(dtype):
    jcfg = jax_smoke("gemma-2b").replace(remat=False, compute_dtype=dtype)
    cfg = get_smoke_config("gemma-2b").replace(remat=False,
                                               compute_dtype=dtype)
    jparams = build(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def setup():
    return _models("float32")


@pytest.fixture(scope="module")
def setup_bf16():
    return _models("bfloat16")


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
    """Direct drive: one turn per agent, step until all resolve."""
    rids = {be.begin_turn(a, "", p): a for a, p in agents.items()}
    return _finish(be, rids, max_steps)


def _finish(be, rids, max_steps=400):
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


def _release_all(engine) -> int:
    for rid in list(engine.reqs):
        engine.release(rid)
    return int(engine.cache.allocator.num_used)


# ----------------------------------------------- cross-engine restore

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_journal_restore_across_differing_engines_bit_exact(
        dtype, setup, setup_bf16, tmp_path):
    """A session journaled on engine A wakes bit-exactly on engine B with a
    different ``max_batch`` and block budget. At bf16 the port's pages
    leave the engine as uint16 bits, and the journal names that dtype."""
    cfg, params = (setup if dtype == "float32" else setup_bf16)[:2]
    agents = {"x": "cross engine restore " * 2}
    t2 = {"x": "second turn payload"}

    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6)
    ref1, _ = _drive(ref_be, agents)
    ref2, _ = _drive(ref_be, t2)

    journal = SessionJournal(str(tmp_path / "xj"))
    a = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6,
                           journal=journal)
    got1, errs = _drive(a, agents)
    assert not errs and got1 == ref1
    rec = journal.load("x")
    want_dt = np.float32 if dtype == "float32" else np.uint16
    assert rec["k_pages"].dtype == want_dt

    b = PagedEngineBackend(_paged(cfg, params, max_batch=2, num_blocks=56),
                           max_new_tokens=6, journal=journal)
    got2, errs = _drive(b, t2)
    assert not errs and got2 == ref2
    assert _release_all(b.engine) == 0


# ------------------------------------------------------- fluid migration

def test_fluid_migration_mid_decode_bit_exact_no_leaks(setup):
    cfg, params = setup[:2]
    prompt = {"m": "stream me " * 4}
    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=20)
    ref, _ = _drive(ref_be, prompt)

    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=20) for i in range(2)],
        fluid_pages_per_tick=1, fluid_handoff_pages=1)
    ext = fleet.begin_turn("m", "", prompt["m"])
    for _ in range(4):
        fleet.step()
    assert fleet.migrate("m", 1, fluid=True) == {"agent": "m",
                                                 "mode": "fluid"}
    outs, errs = _finish(fleet, {ext: "m"})
    assert not errs and outs == ref
    mig = fleet.last_migration
    assert mig.phase == "done" and mig.pages_sent > 0
    assert fleet._home["m"] == 1
    assert fleet.fleet_stats()["migrations_fluid"] == 1
    assert all(_release_all(m.backend.engine) == 0 for m in fleet.members)


def test_interrupted_fluid_migration_leaks_nothing_either_side(setup):
    cfg, params = setup[:2]
    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=16) for i in range(2)],
        fluid_pages_per_tick=1, fluid_handoff_pages=1)
    ext = fleet.begin_turn("x", "", "interrupt me " * 4)
    for _ in range(4):
        fleet.step()
    assert fleet.migrate("x", 1, fluid=True)
    fleet.step()
    assert fleet.interrupt_migrations()
    fleet.step()
    assert not fleet.migration_active("x")
    mig = fleet.last_migration
    assert mig.phase == "aborted"
    assert isinstance(mig.error, MigrationError)
    assert fleet._home["x"] == 0
    outs, _ = _finish(fleet, {ext: "x"})
    assert outs["x"].startswith("tok:")
    tgt = fleet.members[1].backend
    assert not tgt.sessions and len(tgt.engine.swap.store) == 0
    assert all(_release_all(m.backend.engine) == 0 for m in fleet.members)


def test_sudden_migration_then_turn_bit_exact(setup):
    cfg, params = setup[:2]
    agents = {"s": "sudden move " * 2}
    t2 = {"s": "after the move"}
    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6)
    _drive(ref_be, agents)
    ref2, _ = _drive(ref_be, t2)

    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=6) for i in range(2)])
    _drive(fleet, agents)
    src = fleet._home["s"]
    dst = 1 - src
    res = fleet.migrate("s", dst)
    assert res["mode"] == "sudden" and res["pages"] > 0
    assert fleet._home["s"] == dst
    assert fleet.members[src].backend.engine.cache.allocator.num_used == 0
    got2, errs = _drive(fleet, t2)
    assert not errs and got2 == ref2


# ------------------------------------------------------------- failover

def test_engine_loss_fails_inflight_typed_and_restores_bit_exact(
        setup, tmp_path):
    """Kill one of two engines mid-turn: its in-flight turns fail with
    ``EngineLostError`` in that step's report, and re-submitted turns
    restore from the shared journal on the survivor bit-exactly."""
    cfg, params = setup[:2]
    agents = {f"a{i}": f"failover agent {i} " * 2 for i in range(3)}
    t2 = {a: "turn two " + a for a in agents}
    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6)
    _drive(ref_be, agents)
    ref2, _ = _drive(ref_be, t2)

    journal = SessionJournal(str(tmp_path / "fj"))

    def mk(i):
        return PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                                  max_new_tokens=6, journal=journal)

    fleet = FleetBackend([mk(0), mk(1)], journal=journal)
    _drive(fleet, agents)
    homes = dict(fleet._home)
    victim = max(set(homes.values()),
                 key=lambda i: sum(1 for h in homes.values() if h == i))
    doomed = {a for a, h in homes.items() if h == victim}

    rids = {fleet.begin_turn(a, "", p): a for a, p in t2.items()}
    assert fleet.kill_engine(victim)
    rep = fleet.step()
    lost = {rids[r] for r, e in rep.failed
            if r in rids and isinstance(e, EngineLostError)}
    assert lost == doomed
    assert all(isinstance(e, EngineLostError) for _, e in rep.failed)
    for r, _ in rep.failed:
        rids.pop(r, None)
    outs, _ = _finish(fleet, rids)
    retry = {fleet.begin_turn(a, "", t2[a]): a for a in lost}
    more, _ = _finish(fleet, retry)
    outs.update(more)
    assert outs == ref2
    assert fleet.fleet_stats()["sessions_failed_over"] == len(doomed)
    leaked = sum(_release_all(m.backend.engine)
                 for m in fleet.members if m.alive)
    assert leaked == 0


def test_kill_refuses_last_engine_and_loss_hook_respects_floor(setup):
    cfg, params = setup[:2]
    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=4) for i in range(2)])
    assert fleet.kill_engine(0)
    fleet.step()
    assert not fleet.kill_engine(1)
    assert not fleet.inject_engine_loss(3)


# ------------------------------------------------- rebalance / victims

def test_rebalance_for_admission_moves_victim_to_headroom(setup):
    cfg, params = setup[:2]

    def mk(i, blocks):
        return PagedEngineBackend(
            _paged(cfg, params, name=f"engine{i}", num_blocks=blocks),
            max_new_tokens=8, prompt_tokens=48)

    fleet = FleetBackend([mk(0, 18), mk(1, 40)])
    fleet._home = {"w": 0, "v": 0}
    _drive(fleet, {"w": "waiter session " * 8, "v": "victim session " * 8})
    alloc0 = fleet.members[0].backend.engine.cache.allocator
    free_before = alloc0.num_free
    assert fleet.rebalance_for_admission("w", "a new long prompt " * 12)
    assert fleet._home["v"] == 1
    assert fleet._home["w"] == 0
    assert alloc0.num_free > free_before
    assert fleet.fleet_stats()["rebalance_migrations"] == 1
    fleet._home["n"] = 0
    assert fleet.rebalance_for_admission("n", "fresh agent prompt")
    assert fleet._home["n"] == 1


def test_victim_parkable_skips_cold_and_migrating_sessions(setup):
    cfg, params = setup[:2]
    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=30) for i in range(2)],
        fluid_pages_per_tick=1, fluid_handoff_pages=1)
    ext = fleet.begin_turn("p", "", "parkable while decoding " * 2)
    for _ in range(3):
        fleet.step()
    assert fleet.victim_parkable(ext)
    fleet.park_turn(ext)
    assert not fleet.victim_parkable(ext)
    fleet.resume_turn(ext)
    fleet.step()
    assert fleet.migrate("p", 1, fluid=True)
    assert not fleet.victim_parkable(ext)
    assert not fleet.victim_parkable(99999)


# -------------------------------------------------------------- drain

def test_drain_migrates_sessions_and_empties_engine(setup):
    cfg, params = setup[:2]
    fleet = FleetBackend(
        [PagedEngineBackend(_paged(cfg, params, name=f"engine{i}"),
                            max_new_tokens=4) for i in range(2)])
    agents = {f"d{i}": f"drain agent {i}" for i in range(3)}
    _drive(fleet, agents)
    victim = next(iter(set(fleet._home.values())))
    n_there = sum(1 for h in fleet._home.values() if h == victim)
    res = fleet.drain(victim)
    assert res["migrated_now"] == n_there and res["complete"]
    mem = fleet.members[victim]
    assert mem.state == "drained" and not mem.backend.sessions
    assert mem.backend.engine.cache.allocator.num_used == 0
    assert all(h != victim for h in fleet._home.values())
    with pytest.raises(ValueError):
        fleet.drain(victim)
    other = 1 - victim
    with pytest.raises(ValueError):
        fleet.drain(other)
    got, errs = _drive(fleet, {"new": "post drain turn"})
    assert not errs and fleet._home["new"] == other


# ----------------------------------------------------------- disk tier

@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_disk_tier_spills_verifies_and_promotes(dtype, tmp_path):
    """Entries past the RAM capacity spill to disk with a crc32; a
    read-back promotes bit-identical pages (uint16: the bits of the port's
    bf16 pages); flipped bytes on disk surface as
    ``SwapCorruptionError``."""
    store = DiskTierKVSwapStore(str(tmp_path / "spill"),
                                capacity_bytes=10_000)
    rng = np.random.default_rng(0)
    payloads = {}
    for i in range(4):
        k = rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32)
        v = rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32)
        if dtype == np.uint16:
            k, v = k.view(np.uint16), v.view(np.uint16)
        payloads[i] = (k, v)
        store.put(i, (k, v, 24), k.nbytes + v.nbytes)
    stats = store.tier_stats()
    assert stats["swap_disk_sessions"] > 0
    assert stats["swap_ram_bytes"] <= 10_000
    assert len(store) == 4
    for i, (k, v) in payloads.items():
        got_k, got_v, n = store.peek(i)
        assert n == 24
        assert got_k.dtype == dtype and got_v.dtype == dtype
        assert np.array_equal(np.asarray(got_k), k)
        assert np.array_equal(np.asarray(got_v), v)
    store2 = DiskTierKVSwapStore(str(tmp_path / "spill2"),
                                 capacity_bytes=100)
    k, v = payloads[0]
    store2.put("c", (k, v, 24), k.nbytes + v.nbytes)
    store2.put("d", (k, v, 24), k.nbytes + v.nbytes)
    path, _ = store2._disk["c"]
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(SwapCorruptionError):
        store2.peek("c")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disk_tier_behind_engine_hibernate_wake_bit_exact(
        dtype, setup, setup_bf16, tmp_path):
    """Sessions hibernated through a tiny-RAM disk-tier store (every
    payload round-trips via disk) wake bit-exactly, and ``kv_stats``
    reports both tier sizes."""
    cfg, params = (setup if dtype == "float32" else setup_bf16)[:2]
    agents = {"h1": "hibernate me " * 2, "h2": "me too " * 2}
    t2 = {a: "wake turn " + a for a in agents}
    ref_be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=6)
    _drive(ref_be, agents)
    ref2, _ = _drive(ref_be, t2)

    store = DiskTierKVSwapStore(str(tmp_path / "tier"), capacity_bytes=1)
    eng = _paged(cfg, params, swap_store=store)
    be = PagedEngineBackend(eng, max_new_tokens=6)
    _drive(be, agents)
    for a in agents:
        be.hibernate_session(a)
    assert store.tier_stats()["swap_disk_sessions"] >= 1
    ks = eng.kv_stats()
    assert ks["swap_disk_sessions"] >= 1
    assert "swap_ram_bytes" in ks and "swap_disk_bytes" in ks
    got2, errs = _drive(be, t2)
    assert not errs and got2 == ref2
    assert _release_all(eng) == 0


# --------------------------------------- failover across mesh shapes

def test_engine_loss_journal_restore_tp2_to_tp4_bit_exact(tmp_path):
    """``test_fleet.py``'s failover beyond tp 1: a session journaled by a
    tp 2 engine restores exactly on a tp 4 survivor. Journal payloads are
    full-hkv host pages joined from the shards' pools, so a restore does
    not see the mesh's shape; the oracle is the reference's single-device
    engine."""
    from test_torch_sharded import (ENGINE_KW, EXTEND, PROMPT, cpu_mesh,
                                    driver_setup)
    cfg, params, ref_toks = driver_setup()

    def engine(tp):
        return PagedInferenceEngine(cfg, params, mesh=cpu_mesh(tp),
                                    device="cpu", **ENGINE_KW)

    journal = SessionJournal(str(tmp_path / "tpj"))
    a = engine(2)
    rid = a.submit(PROMPT, max_new_tokens=8, retain=True)
    a.run_to_completion()
    turn1 = [int(t) for t in a.reqs[rid].out_tokens]
    payload = a.export_session(rid)
    if payload is None:             # only coherent between turns: park first
        a.park(rid)
        payload = a.export_session(rid)
    journal.commit("agent-x", payload)
    del a                           # the tp 2 engine dies with its pages
    b = engine(4)
    rid2 = b.restore_session(journal.load("agent-x"))
    b.extend(rid2, EXTEND, max_new_tokens=8)
    b.run_to_completion()
    assert turn1 == ref_toks[:8]
    assert [int(t) for t in b.reqs[rid2].out_tokens] == ref_toks[8:]


# ------------------------------------------------- fault-plan contract

def test_fleet_fault_kinds_deterministic_and_noop_on_single_engine(setup):
    kinds = ("engine_loss", "migration_interrupt", "network_delay")
    assert FAULT_KINDS[-3:] == kinds
    rates = {k: 0.2 for k in kinds}
    p1 = FaultPlan.generate(seed=11, n_steps=60, rates=rates)
    p2 = FaultPlan.generate(seed=11, n_steps=60, rates=rates)
    assert [f.to_dict() for f in p1.faults] == \
        [f.to_dict() for f in p2.faults]
    assert sum(p1.counts()[k] for k in kinds) > 0

    cfg, params = setup[:2]
    be = PagedEngineBackend(_paged(cfg, params), max_new_tokens=4)
    plan = FaultPlan([FaultSpec(0, k) for k in kinds])
    chaos = ChaosBackend(be, plan)
    got, errs = _drive(chaos, {"n": "no fleet here"})
    assert not errs and got["n"].startswith("tok:")
    assert all(chaos.injected[k] == 0 for k in kinds)


# -------------------------------------------- a mixed JAX and port fleet

def _mixed_fleet(setup, port_idx, new_tokens):
    """Two members, one a JAX engine and one the port's, with the same
    (converted) weights; member ``port_idx`` is the port's."""
    cfg, params = setup[:2]
    members = []
    for i in range(2):
        if i == port_idx:
            members.append(PagedEngineBackend(
                _paged(cfg, params, name=f"engine{i}"),
                max_new_tokens=new_tokens))
        else:
            members.append(JaxBackend(_jax_paged(setup, name=f"engine{i}"),
                                      max_new_tokens=new_tokens))
    return FleetBackend(members, fluid_pages_per_tick=1,
                        fluid_handoff_pages=1)


@pytest.mark.parametrize("src", [0, 1], ids=["jax_to_port", "port_to_jax"])
def test_mixed_fleet_sudden_migration_bit_exact(src, setup):
    """An idle session moves between a JAX member and a port member, and
    its next turn gives a JAX-only engine's tokens."""
    agents = {"s": "sudden move " * 2}
    t2 = {"s": "after the move"}
    ref_be = JaxBackend(_jax_paged(setup), max_new_tokens=6)
    ref1, _ = _drive(ref_be, agents)
    ref2, _ = _drive(ref_be, t2)

    dst = 1 - src
    fleet = _mixed_fleet(setup, port_idx=1, new_tokens=6)
    fleet._home["s"] = src
    got1, errs = _drive(fleet, agents)
    assert not errs and got1 == ref1
    res = fleet.migrate("s", dst)
    assert res["mode"] == "sudden" and res["pages"] > 0
    assert fleet._home["s"] == dst
    assert fleet.members[src].backend.engine.cache.allocator.num_used == 0
    got2, errs = _drive(fleet, t2)
    assert not errs and got2 == ref2


@pytest.mark.parametrize("src", [0, 1], ids=["jax_to_port", "port_to_jax"])
def test_mixed_fleet_fluid_migration_bit_exact(src, setup):
    """A session fluid-migrates mid-decode between a JAX member and a port
    member: the turn it was decoding and the next one give a JAX-only
    engine's tokens, and no block is left on either side."""
    prompt = {"m": "stream me " * 4}
    t2 = {"m": "the turn after"}
    ref_be = JaxBackend(_jax_paged(setup), max_new_tokens=20)
    ref1, _ = _drive(ref_be, prompt)
    ref2, _ = _drive(ref_be, t2)

    dst = 1 - src
    fleet = _mixed_fleet(setup, port_idx=1, new_tokens=20)
    fleet._home["m"] = src
    ext = fleet.begin_turn("m", "", prompt["m"])
    for _ in range(4):
        fleet.step()
    assert fleet.migrate("m", dst, fluid=True) == {"agent": "m",
                                                   "mode": "fluid"}
    got1, errs = _finish(fleet, {ext: "m"})
    assert not errs and got1 == ref1
    assert fleet.last_migration.phase == "done"
    assert fleet._home["m"] == dst
    got2, errs = _drive(fleet, t2)
    assert not errs and got2 == ref2
    assert all(_release_all(m.backend.engine) == 0 for m in fleet.members)


# ------------------- the re-meshing helpers: one device, or a mesh

def test_remesh_helpers_raise_until_the_port_has_a_mesh(setup):
    """Named for what the port once did: the helpers now take a mesh. A
    single-device target is a move (the checkpointer's restore is
    tests/test_torch_checkpoint.py's); a 1 x 2 ``("data", "model")`` mesh
    places one tree per position under the training rules, whose join is
    the tree; a bare list of several devices names no axes and raises
    ValueError, and so does the serving ``("tp",)`` mesh of two shards."""
    cfg, params = setup[:2]
    assert reshard_params is sharding.reshard_params
    assert elastic_restore is sharding.elastic_restore
    assert reshard_params(cfg, params, mesh=None) is params
    moved = reshard_params(cfg, params, mesh="cpu")
    assert torch.equal(moved["embed"], params["embed"])
    placed = reshard_params(cfg, params,
                            mesh=make_local_mesh(devices=["cpu", "cpu"]))
    assert len(placed) == 2
    joined = sharding.join(placed)
    assert all(torch.equal(a, b) for a, b in zip(leaves(joined),
                                                 leaves(params)))
    for two in (["cpu", "cpu"], make_tp_mesh(2, devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="training rules"):
            reshard_params(cfg, params, mesh=two)
        with pytest.raises(ValueError, match="training rules"):
            elastic_restore(cfg, None, params, mesh=two)
