"""The port's tensor-parallel megastep (DESIGN.md §13) on the CPU, in
process: ``PagedInferenceEngine(mesh=make_tp_mesh(tp, devices=["cpu"] *
tp))``, every shard on the host, against the reference.

The model and schedule are ``tests/_sharded_driver.py``'s (gemma-2b smoke
cut to 2 layers, d_model 64, 8 query heads over 4 KV heads of 16, f32;
one retained session, a submit then an extend), its weights converted from
the reference's ``init_params(PRNGKey(0))``. Contracts:

  * tp 1, 2 and 4 give the JAX reference's single-device engine's tokens;
  * tp 1 leaves the port's mesh-less pools bit for bit;
  * one ``mixed_step_paged`` call and 16 host bytes per step at every tp;
  * a session hibernated at tp 2 wakes at tp 4 and continues exactly;
  * the bucket guard holds under a mesh, and the ``collective.psum``
    instant is traced only under one;
  * steps whose dense layers run on the flat token axis (4 rows x C above
    the budget's 16 slots) give the mesh-less engine's tokens at tp 2;
  * the serving rules (head order, specs, the head permutation) and the
    engine's mesh errors equal the reference's;
  * starcoder2 smoke (a derived head_dim, pinned per shard) and the MoE
    smoke at tp 2 give the reference's tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.distributed import sharding as ref_sharding
from repro.models import build
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.context.tiers import KVSwapStore
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import TPMesh, make_tp_mesh
from repro_torch.obs import Observability, TraceConfig
from repro_torch.serving import PagedInferenceEngine
from repro_torch.weights import params_from_jax

DRIVER = dict(remat=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=256, compute_dtype="float32")
ENGINE_KW = dict(num_blocks=65, block_size=8, max_batch=4, max_len=96,
                 prefill_chunk=16, token_budget=16, megastep=True)
PROMPT = np.arange(1, 20, dtype=np.int32)
EXTEND = np.arange(30, 38, dtype=np.int32)


def models(arch="gemma-2b", **kw):
    """(jax cfg, jax params, port cfg, port params): the reference's
    ``init_params(PRNGKey(0))`` converted, on the CPU."""
    jcfg = jax_smoke(arch).replace(**kw)
    tcfg = get_smoke_config(arch).replace(**kw)
    jparams = build(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                             device="cpu")
    return jcfg, jparams, tcfg, params


def cpu_mesh(tp: int) -> TPMesh:
    return make_tp_mesh(tp, devices=["cpu"] * tp)


def drive(eng):
    """submit + retain, drain, extend, drain: two greedy turns of one
    session; returns (rid, the 16 tokens)."""
    rid = eng.submit(PROMPT, max_new_tokens=8, retain=True)
    eng.run_to_completion()
    t1 = [int(t) for t in eng.reqs[rid].out_tokens]
    eng.extend(rid, EXTEND, max_new_tokens=8)
    eng.run_to_completion()
    return rid, t1 + [int(t) for t in eng.reqs[rid].out_tokens]


def driver_setup():
    """(port cfg, port params, the reference single-device engine's 16
    tokens) of the driver's model and schedule."""
    jcfg, jparams, tcfg, params = models(**DRIVER)
    _, ref_toks = drive(JaxEngine(jcfg, jparams, **ENGINE_KW))
    return tcfg, params, ref_toks


@pytest.fixture(scope="module")
def driver():
    return driver_setup()


def port(driver, mesh=None, **kw):
    return PagedInferenceEngine(driver[0], driver[1], mesh=mesh,
                                device="cpu", **{**ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def runs(driver):
    """tp -> (engine, tokens) after the two turns; tp 0 is mesh-less."""
    out = {}
    for tp in (0, 1, 2, 4):
        eng = port(driver, cpu_mesh(tp) if tp else None)
        out[tp] = (eng, drive(eng)[1])
    return out


# ------------------------------------------------------- parity

@pytest.mark.parametrize("tp", [0, 1, 2, 4])
def test_tokens_equal_reference_single_device(tp, driver, runs):
    assert runs[tp][1] == driver[2]


def test_tp1_pools_bitwise_equal_meshless(runs):
    """The head permutation is the identity at tp 1 and a one-shard sum
    is no op: the pools equal the mesh-less engine's bit for bit (the null
    block excluded, as in the reference's driver)."""
    k0, v0 = runs[0][0].cache.full_pools()
    k1, v1 = runs[1][0].cache.full_pools()
    assert torch.equal(k1[:, 1:], k0[:, 1:])
    assert torch.equal(v1[:, 1:], v0[:, 1:])


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_pools_join_to_the_meshless_pools(tp, runs):
    """Each shard holds its kv-head slice; joined in kv-head order they
    are the mesh-less pools up to f32 summation order."""
    eng = runs[tp][0]
    assert [s["k"].shape[3] for s in eng.cache.pools()] == [4 // tp] * tp
    k0, v0 = runs[0][0].cache.full_pools()
    k, v = eng.cache.full_pools()
    torch.testing.assert_close(k[:, 1:], k0[:, 1:], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(v[:, 1:], v0[:, 1:], atol=1e-5, rtol=1e-5)
    assert eng.cache.block_bytes == runs[0][0].cache.block_bytes
    assert eng.kv_stats()["kv_bytes_in_use"] == \
        runs[0][0].kv_stats()["kv_bytes_in_use"]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_one_call_and_flat_host_transfer(tp, runs):
    st = runs[tp][0].step_stats()
    assert st["tp"] == tp
    assert st["jit_dispatches_per_step"] == 1.0
    assert st["host_transfer_bytes_per_step"] == 4 * 4


def test_one_call_per_step_counts_every_shard(driver, monkeypatch):
    """Each step is one ``mixed_step_paged`` call carrying every shard, and
    every shard's attention runs in every layer."""
    from repro_torch.models import attention, transformer
    calls, attn = [], []
    mega, gqa = transformer.mixed_step_paged, attention.gqa_mixed_step_paged
    monkeypatch.setattr(transformer, "mixed_step_paged",
                        lambda *a, **kw: calls.append(kw) or mega(*a, **kw))
    monkeypatch.setattr(attention, "gqa_mixed_step_paged",
                        lambda p, x, *a, **kw: attn.append(a[-1])
                        or gqa(p, x, *a, **kw))
    eng = port(driver, cpu_mesh(2))
    drive(eng)
    steps = eng.steps_dispatched
    assert len(calls) == steps and all(len(kw["shards"]) == 2
                                       for kw in calls)
    assert len(attn) == 2 * 2 * steps
    assert {(c.n_heads, c.n_kv_heads, c.resolved_head_dim)
            for c in attn} == {(4, 2, 16)}


def test_hibernate_tp2_wake_tp4_bit_exact(driver):
    """Host pages are full-hkv, so a session hibernated under one mesh
    continues exactly under another."""
    store = KVSwapStore()
    a = port(driver, cpu_mesh(2), swap_store=store)
    rid = a.submit(PROMPT, max_new_tokens=8, retain=True)
    a.run_to_completion()
    turn1 = [int(t) for t in a.reqs[rid].out_tokens]
    a.hibernate(rid)
    assert len(store) == 1
    b = port(driver, cpu_mesh(4), swap_store=store)
    b.reqs[rid] = a.reqs[rid]          # adopt the swapped session wholesale
    b._next_rid = rid + 1
    b.extend(rid, EXTEND, max_new_tokens=8)
    b.run_to_completion()
    assert turn1 + [int(t) for t in b.reqs[rid].out_tokens] == driver[2]


def test_bucket_guard_under_mesh(driver):
    eng = port(driver, cpu_mesh(2))
    eng.compile_buckets()
    for i in range(3):
        eng.submit(np.arange(1, 8 + 5 * i, dtype=np.int32),
                   max_new_tokens=4)
    eng.run_to_completion()
    st = eng.step_stats()
    assert set(st["trace_buckets"]) <= set(st["bucket_set"])
    assert eng.compiled_buckets == set(st["bucket_set"])
    assert st["jit_dispatches_per_step"] == 1.0


def test_compile_buckets_writes_only_null_blocks(driver):
    eng = port(driver, cpu_mesh(2))
    eng.compile_buckets()
    for shard in eng.cache.pools():
        for pool in shard.values():
            assert not pool[:, 1:].any()


@pytest.mark.parametrize("tp", [0, 2])
def test_psum_instant_only_under_mesh(tp, driver):
    obs = Observability(trace=TraceConfig(enabled=True))
    eng = port(driver, cpu_mesh(tp) if tp else None, obs=obs)
    drive(eng)
    psums = [e for e in obs.recorder.events()
             if e["name"] == "collective.psum"]
    if not tp:
        assert psums == []
        return
    assert len(psums) == eng.steps_dispatched
    for e in psums:
        # the partials are (N, d): N = min(4 * C, the budget's 16) slots
        n = min(e["args"]["shard_tokens_dispatched"], 16)
        assert e["args"]["tp"] == tp and e["args"]["psums"] == 2
        assert e["args"]["bytes_per_shard"] == 2 * n * 64 * 4


def test_flat_steps_at_tp2_equal_meshless(driver):
    """Three prompts at once: the steps at C = 8 and 16 run their dense
    layers on 16 flat slots (decode rows and prompt chunks end to end,
    spare slots after them) and sum (16, d) partials; tp 2 gives the
    mesh-less engine's tokens, flat steps and, joined, pools."""
    out = {}
    for tp in (0, 2):
        eng = port(driver, cpu_mesh(tp) if tp else None)
        rids = [eng.submit(np.arange(1 + i, 12 + 9 * i) % 256,
                           max_new_tokens=5, retain=True) for i in range(3)]
        eng.run_to_completion()
        out[tp] = eng, [list(eng.reqs[r].out_tokens) for r in rids]
    (e0, want), (e2, got) = out[0], out[2]
    assert got == want
    st0, st2 = e0.step_stats(), e2.step_stats()
    assert st2["flat_steps"] == st0["flat_steps"] > 0
    assert st2["dense_slots"] == st0["dense_slots"]
    for a, b in zip(e2.cache.full_pools(), e0.cache.full_pools()):
        torch.testing.assert_close(a[:, 1:], b[:, 1:], atol=1e-5, rtol=1e-5)


# ---------------------------------------------- the serving rules

GRID = [(hq, hkv, tp, mode) for hq, hkv in ((8, 4), (8, 2), (4, 4), (6, 2))
        for tp in (1, 2, 4) for mode in ("tiled", "grouped")]


def _rule_cfgs(hq, hkv, mode):
    kw = dict(n_layers=2, d_model=64, n_heads=hq, n_kv_heads=hkv,
              head_dim=16, d_ff=128, vocab_size=256, gqa_mode=mode,
              remat=False, compute_dtype="float32")
    return models(**kw)


@pytest.mark.parametrize("hq,hkv,tp,mode", GRID)
def test_serving_rules_equal_reference(hq, hkv, tp, mode):
    """``tp_head_order``, ``serving_param_pspecs`` (the reference's tree,
    specs as tuples) and ``permute_attn_heads`` (on the converted weights)
    equal the reference's, or both refuse with one message."""
    jcfg, jparams, tcfg, params = _rule_cfgs(hq, hkv, mode)
    try:
        want = ref_sharding.tp_head_order(jcfg, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sharding.tp_head_order(tcfg, tp)
        assert str(got.value) == str(e)
        return
    assert sharding.tp_head_order(tcfg, tp) == want
    np_tree = jax.tree.map(np.asarray, jparams)
    want_specs = jax.tree.map(tuple, ref_sharding.serving_param_pspecs(
        jcfg, tp, jparams), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    got_specs = sharding.serving_param_pspecs(tcfg, tp, np_tree)
    assert got_specs == want_specs
    want_perm = params_from_jax(jax.tree.map(
        np.asarray, ref_sharding.permute_attn_heads(jcfg, tp, jparams)),
        tcfg, device="cpu")
    got_perm = sharding.permute_attn_heads(tcfg, tp, params)
    for got, want in zip(jax.tree.leaves(got_perm),
                         jax.tree.leaves(want_perm)):
        assert torch.equal(got, want)


def test_pool_and_row_specs_equal_reference():
    P = jax.sharding.PartitionSpec
    assert sharding.kv_pool_pspec() == tuple(ref_sharding.kv_pool_pspec())
    assert sharding.megastep_input_pspecs() == tuple(
        tuple(s) for s in ref_sharding.megastep_input_pspecs())
    assert sharding.megastep_output_pspec() == tuple(P()) == ()
    assert sharding.TP == ref_sharding.TP


def test_serving_specs_strict_on_indivisible():
    _, _, tcfg, params = _rule_cfgs(8, 4, "tiled")
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        sharding.serving_param_pspecs(tcfg, 3, params)


def test_shard_serving_params_slices_and_shares(driver):
    """Attention columns (wq/wk/wv) and wo rows are cut contiguously after
    the permutation; every other leaf is placed once per distinct device:
    the shards on one device share it, and one already there is the very
    tensor that was passed."""
    tcfg, params, _ = driver
    placed = sharding.shard_serving_params(tcfg, cpu_mesh(4), params)
    perm = sharding.permute_attn_heads(tcfg, 4, params)
    specs = sharding.serving_param_pspecs(tcfg, 4, params)
    assert specs["layers"][0]["attn"]["wq"] == (None, "tp")
    assert specs["layers"][0]["attn"]["wo"] == ("tp", None)
    for i, tree in enumerate(placed):
        attn, want = tree["layers"][1]["attn"], perm["layers"][1]["attn"]
        assert torch.equal(attn["wq"], want["wq"][:, i * 32:(i + 1) * 32])
        assert torch.equal(attn["wk"], want["wk"][:, i * 16:(i + 1) * 16])
        assert torch.equal(attn["wo"], want["wo"][i * 32:(i + 1) * 32])
        assert tree["embed"] is params["embed"]
        assert tree["layers"][1]["mlp"]["w_up"] is \
            params["layers"][1]["mlp"]["w_up"]
    one = sharding.shard_serving_params(tcfg, cpu_mesh(1), params)
    assert one[0]["layers"][0]["attn"]["wq"].data_ptr() == \
        params["layers"][0]["attn"]["wq"].data_ptr()


# ------------------------------------------------- mesh and errors

class FakeMesh:
    axis_names = ("tp",)

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("kw", [dict(mesh=FakeMesh({"model": 2})),
                                dict(mesh=FakeMesh({"tp": 2}),
                                     megastep=False),
                                dict(mesh=FakeMesh({"tp": 2}))],
                         ids=["no_tp_axis", "legacy_loop", "indivisible"])
def test_engine_mesh_errors_equal_reference(kw):
    """``test_sharded_megastep.py``'s three refusals, before any device or
    param is touched (gemma-2b smoke is MQA: nothing above tp 1 divides
    it)."""
    cfg = get_smoke_config("gemma-2b").replace(remat=False)
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_smoke("gemma-2b").replace(remat=False), None, **kw)
    with pytest.raises(ValueError) as got:
        PagedInferenceEngine(cfg, None, **kw)
    assert str(got.value) == str(want.value)


def test_make_tp_mesh(monkeypatch):
    one = make_tp_mesh(1, device="cpu")
    assert one.axis_names == ("tp",) and one.shape == {"tp": 1}
    assert one.devices == (torch.device("cpu"),)
    four = cpu_mesh(4)
    assert four.shape == {"tp": 4}
    assert four.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match=r"^tp=2 exceeds the 1 visible "
                       r"device\(s\)"):
        make_tp_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        make_tp_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="one device per shard"):
        make_tp_mesh(2, devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_tp_mesh(1),
                 lambda: make_tp_mesh(2, devices=["cuda"] * 2)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


# ----------------------------------------- other families at tp 2

@pytest.mark.parametrize("arch", ["starcoder2-7b", "llama4-scout-17b-a16e"])
def test_family_at_tp2_equals_reference(arch):
    """starcoder2 smoke derives head_dim 64 / 4 = 16: pinned per shard, or
    it would become 32 at tp 2. llama4-scout's MoE runs replicated on the
    summed residual stream."""
    jcfg, jparams, tcfg, params = models(arch, remat=False,
                                         compute_dtype="float32")
    assert tcfg.head_dim == 0
    _, want = drive(JaxEngine(jcfg, jparams, **ENGINE_KW))
    eng = PagedInferenceEngine(tcfg, params, mesh=cpu_mesh(2), device="cpu",
                               **ENGINE_KW)
    assert drive(eng)[1] == want
