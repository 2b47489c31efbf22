"""The compiled dispatch of the port's serving engines (``cuda_graphs``,
``serving/graphs.py``) on the CPU, at float32, against the reference:

  * after ``cache.set_pools`` the megastep and the legacy loop write the
    new pools: tokens equal the reference engine's (after the same
    ``set_pools``), the sessions' pages equal the same engine's run
    without the rebind bit for bit and the reference's within 1e-5 (the
    two frameworks' float32 products round apart by ~2e-6 with no rebind
    at all);
  * the staged-buffer route (static inputs restaged every step, captured
    steps replayed; on the CPU the stand-in ``capture_eager`` replays by
    running the function again) gives the fresh-tensor route's tokens and
    pools bit for bit and the reference's tokens, on traffic where a wide
    step is followed by narrower ones and a released row's slot and blocks
    are taken by a new prompt;
  * ``cuda_graphs`` resolves to False off the card and ``True`` there
    raises ``ValueError``;
  * the launch accounting: what a capture adds to the kernel wrappers'
    counts is put back, each replay adds it, a failed capture raises.

  * the legacy loop's chunked prefill with ``cache_len`` / ``valid``
    staged as (1,) int32 tensors equals the call with ints bit for bit
    and the reference's within 1e-4; the engine captures it once per chunk
    width, and ``set_pools`` drops that graph too;
  * the dense engine's prefill, one captured step per prompt length
    replayed at other slots, equals the eager one and the reference's.

The replays on the card (bit for bit against the eager step, at tp 1 and
2, the recapture after ``set_pools``, the launches per replay) are the
``gpu`` cases of ``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build
from repro.models import transformer as jtr
from repro.serving import InferenceEngine as JaxDense
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import transformer as ttr
from repro_torch.serving import InferenceEngine, PagedInferenceEngine, graphs
from repro_torch.weights import params_from_jax

KW = {"mega": dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
                   token_budget=16),
      "legacy": dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
                     prefill_chunk=8, megastep=False)}
PROMPTS = [(np.arange(30) + 3) % 200, (np.arange(17) * 7) % 256,
           np.arange(9) % 50]
LATE = (np.arange(12) * 5 + 1) % 256


@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_smoke("gemma-2b").replace(remat=False,
                                         compute_dtype="float32")
    tcfg = get_smoke_config("gemma-2b").replace(remat=False,
                                                compute_dtype="float32")
    params = build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


def _port(models, loop, route, **kw):
    eng = PagedInferenceEngine(models[2], models[3], device="cpu",
                               **{**KW[loop], **kw})
    if route == "staged":
        eng.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    return eng


def _set_pools_run(eng, rebind):
    rid = eng.submit(PROMPTS[2], max_new_tokens=6, retain=True)
    for _ in range(3):      # the prompt, then decode steps
        eng.step()
    if rebind:
        eng.cache.set_pools(rebind(eng.cache.pools()))
    eng.run_to_completion()
    return list(eng.reqs[rid].out_tokens), eng.cache.gather(
        eng.reqs[rid].table)


@pytest.mark.parametrize("route", ["eager", "staged"])
@pytest.mark.parametrize("loop", ["mega", "legacy"])
def test_set_pools_rebinds_what_the_step_writes(gemma, loop, route):
    jeng = JaxEngine(gemma[0], gemma[1], **KW[loop])
    want_toks, want = _set_pools_run(
        jeng, lambda p: {n: jnp.array(np.asarray(t)) for n, t in p.items()})
    clones = lambda p: [{n: t.clone() for n, t in s.items()} for s in p]
    eng = _port(gemma, loop, route)
    old = eng.cache.pools()
    toks, got = _set_pools_run(eng, clones)
    assert eng.cache.pools() is not old
    base_toks, base = _set_pools_run(_port(gemma, loop, route), None)
    assert toks == base_toks == want_toks
    for g, b, w in zip(got, base, want):
        np.testing.assert_array_equal(g, b)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    if route == "staged":
        # the captured steps of the old pools were dropped, then each key
        # captured anew at its next call
        st = eng.graph_stats()
        assert st["first_calls"] > st["graphs"] >= 1


def _traffic(eng):
    """Three prompts (the first steps pack wide chunks), the second
    released mid-turn, a late prompt taking its slot and blocks."""
    rids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    for _ in range(3):
        eng.step()
    eng.release(rids[1])
    rids[1] = eng.submit(LATE, max_new_tokens=5)
    done = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
    return [done[r] for r in rids]


def _pools(eng):
    return [t.clone() for s in eng.cache.pools() for t in s.values()]


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("loop", ["mega", "legacy"])
def test_staged_route_equals_fresh_tensors_and_reference(gemma, loop,
                                                         compiled):
    want = _traffic(JaxEngine(gemma[0], gemma[1], **KW[loop]))
    eager = _port(gemma, loop, "eager")
    staged = _port(gemma, loop, "staged")
    if compiled:
        eager.compile_buckets()
        staged.compile_buckets()
    assert _traffic(eager) == _traffic(staged) == want
    for a, b in zip(_pools(staged), _pools(eager)):
        assert torch.equal(a, b)
    st, steps = staged.graph_stats(), staged.steps_dispatched
    if loop == "mega":
        # one step, one call of its width's captured step
        assert staged.jit_dispatches_per_step == 1.0
        assert len(staged.trace_buckets) > 1
        assert staged.compiled_buckets == (
            set(staged.bucket_set) if compiled else staged.trace_buckets)
        assert st["replays"] + st["first_calls"] == steps + (
            len(staged.bucket_set) if compiled else 0)
        assert st["first_calls"] == len(staged.compiled_buckets)
    else:
        # the decode and the chunk (one chunk width) are captured, each
        # at its first call
        chunks = staged.jit_dispatches - staged.decode_steps
        assert set(staged.graphs.steps) == {"decode", ("chunk", 8)}
        assert st["graphs"] == st["first_calls"] == 2
        assert st["replays"] == staged.decode_steps - 1 + chunks - 1


def test_dense_decode_staged_equals_eager_and_reference(gemma):
    def traffic(eng):
        rids = [eng.submit(p, max_new_tokens=5) for p in PROMPTS + [LATE]]
        done = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
        return [done[r] for r in rids]

    want = traffic(JaxDense(gemma[0], gemma[1], max_slots=2, max_len=64))
    kw = dict(max_slots=2, max_len=64, device="cpu")
    eager = InferenceEngine(gemma[2], gemma[3], **kw)
    staged = InferenceEngine(gemma[2], gemma[3], **kw)
    staged.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    assert traffic(eager) == traffic(staged) == want
    for name in eager.state:
        assert torch.equal(eager.state[name], staged.state[name])
    # the decode, and one prefill per prompt length, each captured at its
    # first call
    lengths = {len(p) for p in PROMPTS + [LATE]}
    prefills = staged.jit_dispatches - staged.steps_dispatched
    st = staged.graph_stats()
    assert set(staged.graphs.steps) == {"decode"} | {
        ("prefill", n) for n in lengths}
    assert st["first_calls"] == st["graphs"] == 1 + len(lengths)
    assert st["replays"] == staged.steps_dispatched - 1 + prefills - len(
        lengths)


# (cache_len, valid) of consecutive chunks of width 8 over one table
CHUNKS = [(0, 8), (8, 8), (16, 3), (5, 1), (40, 8)]


def test_chunk_with_device_lengths_equals_ints_and_reference(gemma):
    """``prefill_chunk_paged`` staged as the engine captures it (the
    lengths (1,) int32 views of one buffer, replayed for every chunk)
    against the call with ints on a copy of the pools, bit for bit, and
    the reference's logits and pools."""
    jcfg, params, tcfg, tp = gemma
    rng = np.random.default_rng(7)
    shape = (tcfg.n_layers, 9, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    table = rng.permutation(np.arange(1, 9)).astype(np.int32)
    staged = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    plain = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    jpools = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    g = graphs.StepGraphs("cpu", capture=graphs.capture_eager)

    def chunk(toks, cache_len, valid, table):
        assert cache_len.shape == valid.shape == (1,)
        return ttr.prefill_chunk_paged(tp, staged, toks, cache_len, valid,
                                       table, tcfg)

    for n, t in CHUNKS:
        toks = np.zeros((1, 8), np.int32)
        toks[0, :t] = rng.integers(1, tcfg.vocab_size, t)
        got = g.run(("chunk", 8), chunk, {
            "toks": toks, "cache_len": np.array([n], np.int32),
            "valid": np.array([t], np.int32), "table": table}).clone()
        want = ttr.prefill_chunk_paged(tp, plain, torch.from_numpy(toks), n,
                                       t, torch.from_numpy(table), tcfg)
        ref, jpools = jtr.prefill_chunk_paged(
            params, jpools, jnp.asarray(toks), n, t, jnp.asarray(table),
            jcfg)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got[0, :t].numpy(),
                                   np.asarray(ref)[0, :t], atol=1e-4,
                                   rtol=1e-4)
    for name in ("k", "v"):
        assert torch.equal(staged[name], plain[name])
        np.testing.assert_allclose(staged[name].numpy(),
                                   np.asarray(jpools[name]), atol=1e-5,
                                   rtol=1e-5)
    assert g.stats()["first_calls"] == 1
    assert g.stats()["replays"] == len(CHUNKS) - 1


@pytest.mark.parametrize("prefill_chunk", [8, 16])
def test_legacy_captures_one_chunk_graph_per_width(gemma, prefill_chunk):
    """Prompts of several chunks: one captured chunk step (at the engine's
    chunk width) and one decode, every later chunk a replay."""
    eng = _port(gemma, "legacy", "staged", prefill_chunk=prefill_chunk)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=3)
    eng.run_to_completion()
    chunks = eng.jit_dispatches - eng.decode_steps
    assert chunks > len(PROMPTS)
    st = eng.graph_stats()
    assert set(eng.graphs.steps) == {"decode", ("chunk", prefill_chunk)}
    assert st["first_calls"] == 2
    assert st["replays"] == chunks - 1 + eng.decode_steps - 1


def test_set_pools_drops_the_chunk_graph(gemma):
    """A chunk captured over the old pools is not replayed after
    ``set_pools``: the next chunk captures anew over the new ones."""
    eng = _port(gemma, "legacy", "staged")
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.step()
    old = eng.graphs.steps[("chunk", 8)]
    eng.run_to_completion()
    eng.cache.set_pools([{n: t.clone() for n, t in s.items()}
                         for s in eng.cache.pools()])
    eng.submit(PROMPTS[1], max_new_tokens=2)
    eng.step()
    new = eng.graphs.steps[("chunk", 8)]
    assert new is not old
    assert eng.graph_stats()["first_calls"] == 3      # chunk, decode, chunk


DENSE_PROMPTS = [np.arange(12) % 97 + 1, (np.arange(9) * 3) % 200 + 1,
                 (np.arange(12) * 7) % 256, np.arange(9) + 40,
                 (np.arange(12) * 5) % 211, (np.arange(20) * 3) % 256]


def test_dense_prefill_per_length_equals_eager_and_reference(gemma):
    """Prompts of three lengths through two slots: one captured prefill per
    length, replayed at whichever slot is free; tokens equal the eager
    engine's and the reference's, the caches bit for bit."""
    def traffic(eng):
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(DENSE_PROMPTS, (6, 3, 4, 4, 3, 4))]
        done = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
        return [done[r] for r in rids]

    want = traffic(JaxDense(gemma[0], gemma[1], max_slots=2, max_len=64))
    kw = dict(max_slots=2, max_len=64, device="cpu")
    eager = InferenceEngine(gemma[2], gemma[3], **kw)
    staged = InferenceEngine(gemma[2], gemma[3], **kw)
    staged.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    slots = []
    run = staged.graphs.run

    def spy(key, fn, arrays=None):
        if key != "decode":
            slots.append((key[1], int(arrays["slot"][0])))
        return run(key, fn, arrays)

    staged.graphs.run = spy
    assert traffic(eager) == traffic(staged) == want
    for name in eager.state:
        assert torch.equal(eager.state[name], staged.state[name])
    lengths = {len(p) for p in DENSE_PROMPTS}
    # a length replayed at both slots
    assert {s for n, s in slots if n == 12} == {0, 1}
    st = staged.graph_stats()
    assert set(staged.graphs.steps) == {"decode"} | {
        ("prefill", n) for n in lengths}
    assert st["first_calls"] == 1 + len(lengths)
    assert st["replays"] == (staged.steps_dispatched - 1
                             + len(DENSE_PROMPTS) - len(lengths))


DRIVER = dict(remat=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=256, compute_dtype="float32")


@pytest.mark.parametrize("build_engine", [
    lambda cfg, p, **kw: PagedInferenceEngine(cfg, p, device="cpu", **kw),
    lambda cfg, p, **kw: PagedInferenceEngine(cfg, p, device="cpu",
                                              megastep=False, **kw),
    lambda cfg, p, **kw: InferenceEngine(cfg, p, device="cpu", **kw),
], ids=["megastep", "legacy", "dense"])
def test_cuda_graphs_resolve_off_the_card(gemma, build_engine):
    eng = build_engine(gemma[2], gemma[3])
    assert eng.cuda_graphs is False and eng.graphs is None
    assert eng.graph_stats() == {"cuda_graphs": False}
    assert build_engine(gemma[2], gemma[3],
                        cuda_graphs=False).graphs is None
    with pytest.raises(ValueError, match="cuda_graphs=True needs"):
        build_engine(gemma[2], gemma[3], cuda_graphs=True)


def test_cuda_graphs_refuse_meta_and_several_devices():
    cfg = get_smoke_config("gemma-2b").replace(**DRIVER)
    with pytest.raises(ValueError, match="cuda_graphs=True needs"):
        PagedInferenceEngine(cfg, {}, device="meta", cuda_graphs=True)
    # two cards: refused before any parameter or pool reaches them
    mesh = TPMesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="cuda_graphs=True needs one CUDA"):
        PagedInferenceEngine(cfg, {}, mesh=mesh, cuda_graphs=True)


class _Recorder:
    """A stand-in graph: capturing runs the function's Python once, as
    ``torch.cuda.graph`` does (and launches nothing); replays are
    counted."""

    def __init__(self, fn, out):
        fn()
        self.out, self.replays = out, 0

    def replay(self):
        self.replays += 1
        return self.out


def _fake_step(toks):
    pa.paged_prefill_attention.launches += 3
    da.decode_attention.launches += 1
    return toks.sum()


@pytest.mark.parametrize("replays", [0, 1, 4])
def test_launch_delta_per_replay(replays, monkeypatch):
    monkeypatch.setattr(pa.paged_prefill_attention, "launches", 10)
    monkeypatch.setattr(da.decode_attention, "launches", 0)
    made = []

    def capture(fn, device, pool, stream):
        made.append(_Recorder(fn, torch.tensor(-1)))
        return made[-1]

    g = graphs.StepGraphs("cpu", capture=capture)
    arrays = {"toks": np.arange(6, dtype=np.int32).reshape(2, 3)}
    # the first call is the warm-up, which runs the step: its launches count
    assert int(g.run("k", _fake_step, arrays)) == 15
    assert (pa.paged_prefill_attention.launches,
            da.decode_attention.launches) == (13, 1)
    step = g.steps["k"]
    assert step.launch_delta == {pa.paged_prefill_attention: 3,
                                 da.decode_attention: 1}
    for _ in range(replays):
        assert int(g.run("k", _fake_step, arrays)) == -1
    assert made[0].replays == g.replays == replays
    assert (pa.paged_prefill_attention.launches,
            da.decode_attention.launches) == (13 + 3 * replays,
                                              1 + replays)
    assert g.stats()["first_calls"] == 1


def test_failed_capture_raises_and_keeps_counts(monkeypatch):
    monkeypatch.setattr(pa.paged_prefill_attention, "launches", 0)
    monkeypatch.setattr(da.decode_attention, "launches", 0)

    def capture(fn, device, pool, stream):
        fn()
        raise RuntimeError("capture refused")

    g = graphs.StepGraphs("cpu", capture=capture)
    with pytest.raises(RuntimeError, match="capture refused"):
        g.run("k", _fake_step, {"toks": np.zeros((2, 3), np.int32)})
    assert "k" not in g.steps
    # the warm-up's launches stand, the capture's are put back
    assert (pa.paged_prefill_attention.launches,
            da.decode_attention.launches) == (3, 1)


def test_static_inputs_restage_every_element():
    inputs = graphs.StaticInputs({"toks": (2, 3), "poison": (2,)}, "cpu")
    inputs.stage({"toks": np.full((2, 3), 7, np.int32),
                  "poison": np.array([True, True])})
    inputs.stage({"toks": np.zeros((2, 3), np.int32),
                  "poison": np.array([False, True])})
    assert inputs.views["toks"].tolist() == [[0] * 3] * 2
    assert inputs.views["poison"].tolist() == [0, 1]
    with pytest.raises(ValueError):
        inputs.stage({"toks": np.zeros((2, 3), np.int32)})
    with pytest.raises(ValueError):
        inputs.stage({"toks": np.zeros((1, 3), np.int32),
                      "poison": np.zeros((2,), np.bool_)})
