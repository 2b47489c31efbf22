"""The port's PagedInferenceEngine against the reference engine on the CPU.

At float32 the same prompts (two turns each, under a token budget) give the
same tokens from both engines on gemma-2b smoke (MQA) and chatglm3-6b smoke
(hq4/hkv2). Park/resume and hibernate/wake continue bit-exactly, every
step is one ``mixed_step_paged`` call, and a mid-turn ``export_live``
payload of the JAX engine adopts into the port and finishes with the
reference's tokens. The budget of 16 over 4 rows puts the buckets 8 and 16
on the flat route (their dense layers on 16 slots): every test here runs
it, and one counts it."""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.serving import PagedInferenceEngine, budget_buckets, graphs
from repro_torch.serving.paging import engine as teng
from repro_torch.weights import params_from_jax

KW = dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
          token_budget=16)
PROMPTS = [np.arange(9) % 50, (np.arange(30) + 3) % 200,
           (np.arange(17) * 7) % 256]


def _models(arch, dtype="float32"):
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype=dtype)
    tcfg = get_smoke_config(arch).replace(remat=False, compute_dtype=dtype)
    params = build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module")
def gemma():
    return _models("gemma-2b")


def _port(models, **kw):
    return PagedInferenceEngine(models[2], models[3], device="cpu",
                                **{**KW, **kw})


def _two_turns(eng):
    rids = [eng.submit(p, max_new_tokens=6, retain=True) for p in PROMPTS]
    eng.run_to_completion()
    out = [list(eng.reqs[r].out_tokens) for r in rids]
    for r in rids:
        eng.extend(r, np.arange(5) + 1, 4)
    eng.run_to_completion()
    return out + [list(eng.reqs[r].out_tokens) for r in rids]


@pytest.mark.parametrize("arch", ["gemma-2b", "chatglm3-6b"])
def test_same_tokens_as_reference_engine(arch, gemma):
    models = gemma if arch == "gemma-2b" else _models(arch)
    want = _two_turns(JaxEngine(models[0], models[1], **KW))
    eng = _port(models)
    assert _two_turns(eng) == want
    stats = eng.step_stats()
    assert stats["jit_dispatches_per_step"] == 1.0
    assert set(stats["trace_buckets"]) <= set(stats["bucket_set"])
    assert stats["bucket_set"] == list(budget_buckets(16))


def _retuned_turns(eng):
    """Two turns, then one more turn at each budget rung from the top
    down (``set_token_budget`` live, between turns)."""
    out = _two_turns(eng)
    for budget in reversed(eng.budget_rungs()):
        eng.set_token_budget(budget)
        for r in list(eng.reqs):
            eng.extend(r, np.arange(11) + budget, 3)
        eng.run_to_completion()
        out += [list(eng.reqs[r].out_tokens) for r in eng.reqs]
    return out


def test_flat_route_counts_and_keeps_the_graphs(gemma):
    """The reference engine's tokens through the retunes. ``flat_steps``
    counts exactly the steps whose 4 x C slots exceed the 16 flat ones
    (never a decode-only step), ``dense_slots`` the slots the dense layers
    ran on; ``tokens_dispatched`` still counts 4 x C a step. The captured
    widths are the bucket set's, and the retunes capture nothing new."""
    want = _retuned_turns(JaxEngine(gemma[0], gemma[1], **KW))
    eng = _port(gemma)
    eng.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    eng.compile_buckets()
    keys = set(eng.graphs.steps)
    assert keys == {("mega", C) for C in eng.bucket_set}
    assert eng.flat_width == {1: 4, 8: 16, 16: 16}
    widths = []
    stage = eng._stage
    eng._stage = lambda key, fn, arrays: (widths.append(key[1])
                                          or stage(key, fn, arrays))
    assert _retuned_turns(eng) == want
    st = eng.step_stats()
    assert 1 in widths and 8 in widths and 16 in widths
    assert st["flat_steps"] == sum(C > 4 for C in widths)
    assert st["dense_slots"] == sum(min(4 * C, 16) for C in widths)
    assert st["tokens_dispatched"] == sum(4 * C for C in widths)
    assert st["steps_dispatched"] == len(widths)
    assert set(eng.graphs.steps) == keys
    assert eng.graphs.first_calls == len(keys)
    assert eng.flat_width == {1: 4, 8: 16, 16: 16}


def test_park_resume_mid_decode_is_bit_exact(gemma):
    ref_eng = _port(gemma)
    r = ref_eng.submit(PROMPTS[0], max_new_tokens=8, retain=True)
    ref_eng.run_to_completion()
    eng = _port(gemma)
    rid = eng.submit(PROMPTS[0], max_new_tokens=8, retain=True)
    for _ in range(4):
        eng.step()
    eng.park(rid)
    other = eng.submit(PROMPTS[1], max_new_tokens=3)
    eng.run_to_completion()
    assert other not in eng.reqs
    eng.hibernate(rid)
    assert eng.reqs[rid].state == "swapped"
    eng.resume(rid)
    eng.run_to_completion()
    assert eng.reqs[rid].out_tokens == ref_eng.reqs[r].out_tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hibernate_wake_is_bit_exact(dtype, gemma):
    """A bf16 pool's pages travel as raw uint16 bits and come back
    unchanged."""
    models = gemma if dtype == "float32" else _models("gemma-2b", dtype)
    ref_eng = _port(models)
    a = ref_eng.submit(PROMPTS[1], max_new_tokens=5, retain=True)
    ref_eng.run_to_completion()
    ref_eng.extend(a, np.arange(7) + 2, 5)
    ref_eng.run_to_completion()
    eng = _port(models)
    rid = eng.submit(PROMPTS[1], max_new_tokens=5, retain=True)
    eng.run_to_completion()
    k, v = eng.cache.gather(eng.reqs[rid].table)
    assert k.dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
    assert k.shape[0] == models[2].n_layers and k.shape[2:] == (8, 1, 16)
    eng.hibernate(rid)
    eng.wake(rid)
    k2, v2 = eng.cache.gather(eng.reqs[rid].table)
    np.testing.assert_array_equal(k, k2)
    np.testing.assert_array_equal(v, v2)
    eng.extend(rid, np.arange(7) + 2, 5)
    eng.run_to_completion()
    assert eng.reqs[rid].out_tokens == ref_eng.reqs[a].out_tokens


def test_jax_export_live_adopts_into_port(gemma):
    """A session the JAX engine parked mid-decode moves to the port through
    ``export_live``/``import_live`` and finishes with the same tokens."""
    jeng = JaxEngine(gemma[0], gemma[1], **KW)
    rid = jeng.submit(PROMPTS[2], max_new_tokens=10, retain=True)
    for _ in range(5):
        jeng.step()
    jeng.park(rid)
    payload = jeng.export_live(rid)
    assert not payload["done"]
    jeng.resume(rid)
    jeng.run_to_completion()
    eng = _port(gemma)
    nrid = eng.import_live(payload)
    eng.resume(nrid)
    eng.run_to_completion()
    assert eng.reqs[nrid].out_tokens == jeng.reqs[rid].out_tokens


def test_compile_buckets_leaves_live_state_untouched(gemma):
    eng = _port(gemma)
    rid = eng.submit(PROMPTS[0], max_new_tokens=4, retain=True)
    eng.run_to_completion()
    k, v = eng.cache.gather(eng.reqs[rid].table)
    eng.compile_buckets()
    assert eng.compiled_buckets == set(eng.bucket_set)
    k2, v2 = eng.cache.gather(eng.reqs[rid].table)
    np.testing.assert_array_equal(k, k2)
    np.testing.assert_array_equal(v, v2)


def test_budget_validation_and_later_slices(gemma):
    eng = _port(gemma)
    assert eng.set_token_budget(8) == 8
    with pytest.raises(ValueError):
        eng.set_token_budget(12)            # not a bucket
    with pytest.raises(ValueError):
        _port(gemma, token_budget=2)        # below max_batch
    legacy = _port(gemma, megastep=False)   # the legacy loop is ported now
    assert not legacy.use_megastep
    # the tensor-parallel mesh is ported: its refusals are the reference's
    # (gemma-2b smoke is MQA, so no tp above 1 divides its KV heads)
    mesh = make_tp_mesh(2, devices=["cpu"] * 2)
    for kw in (dict(mesh=mesh), dict(mesh=mesh, megastep=False)):
        with pytest.raises(ValueError) as want:
            JaxEngine(gemma[0], gemma[1], **{**KW, **kw})
        with pytest.raises(ValueError) as got:
            _port(gemma, **kw)
        assert str(got.value) == str(want.value)
    assert teng._MIN_CHUNK_BUCKET == 8


def test_fork_shares_pages_copy_on_write(gemma):
    eng = _port(gemma)
    rid = eng.submit(PROMPTS[1], max_new_tokens=3, retain=True)
    eng.run_to_completion()
    clone = eng.fork(rid)
    shared = list(eng.reqs[clone].table.blocks)
    assert shared == eng.reqs[rid].table.blocks
    eng.extend(clone, np.arange(3) + 1, 2)
    eng.extend(rid, np.arange(3) + 1, 2)
    eng.run_to_completion()
    assert eng.reqs[clone].out_tokens == eng.reqs[rid].out_tokens
    assert eng.reqs[clone].table.blocks[-1] != eng.reqs[rid].table.blocks[-1]

