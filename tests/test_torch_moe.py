"""The port's MoE (``repro_torch.models.moe``) and the llama4-scout MoE
family against the reference on the CPU, at float32, weights from the
reference's initialisation:

  * ``apply_moe`` against ``repro.models.moe.apply_moe`` for both
    dispatches, at capacity factor 1.0 (tokens dropped) and 4.0, with T not
    a multiple of the 256-token group, at top-1 (llama4-scout) and top-2
    (deepseek-v2-lite smoke): the router's expert indices equal first, so
    a mismatch points at routing; then the output within 1e-4, aux and z
    losses within 1e-5;
  * llama4-scout smoke: ``forward`` logits within 1e-4; ``decode_step``
    token by token and ``prefill`` + ``decode_step`` against ``forward``
    within 2e-3 at capacity factor 8 (the reference's
    test_decode_matches_full_forward);
  * an MoE's page writes leave each slot written twice with its last
    write, as the reference's scatter does (idle rows read the null block,
    and their tokens take expert capacity);
  * the port's ``PagedInferenceEngine`` (the megastep, every column routed,
    padding included) gives the reference engine's tokens, two turns of
    three prompts under a token budget, and its dense engine too;
  * a flat width below B * C leaves an MoE's megastep on its padded path
    (its capacity counts the padding slots): the step without ``flat``
    bit for bit, the reference's ids and pools, no flat step counted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serving import InferenceEngine as JaxDense
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, build, moe
from repro_torch.models import transformer as ttr
from repro_torch.serving import InferenceEngine, PagedInferenceEngine
from repro_torch.weights import numpy_to_torch, params_from_jax

ARCH = "llama4-scout-17b-a16e"
KW = dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
          token_budget=16)
PROMPTS = [np.arange(9) % 50, (np.arange(30) + 3) % 200,
           (np.arange(17) * 7) % 256]


def _cfgs(arch, **moe_kw):
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(remat=False,
                                          compute_dtype="float32")
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def _convert(tree):
    return {k: _convert(v) if isinstance(v, dict) else
            numpy_to_torch(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b"],
                         ids=["top1", "top2"])
@pytest.mark.parametrize("cf", [1.0, 4.0])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_apply_moe_matches_reference(arch, cf, dispatch):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, dispatch=dispatch)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = _convert(jp)
    # T = 300: a full group of 256 and a padded one
    x = np.random.default_rng(1).standard_normal(
        (3, 100, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, jcfg.d_model)
    _, jidx, _, _ = jmoe._router(jp, jnp.asarray(xf), jcfg.moe)
    _, idx, _, _ = moe._router(tp, torch.from_numpy(xf), tcfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want, jaux, jz = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux, z = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    assert float(z) == pytest.approx(float(jz), abs=1e-5)
    if cf == 1.0 and dispatch == "einsum":
        # the case must drop tokens, or it does not test capacity
        counts = np.bincount(np.asarray(jidx)[:256].ravel(),
                             minlength=jcfg.moe.n_experts)
        assert counts.max() > moe._capacity(256, tcfg.moe)


def test_router_breaks_ties_by_lower_index():
    """Equal probabilities pick the lower expert first, as jax.lax.top_k."""
    m = get_smoke_config("deepseek-v2-lite-16b").moe
    params = {"router": torch.zeros((8, m.n_experts))}
    _, idx, _, _ = moe._router(params, torch.ones((5, 8)), m)
    assert idx.tolist() == [list(range(m.top_k))] * 5


def test_page_writes_keep_the_last_of_each_slot_as_the_reference():
    """The paged members' page writes: a slot written several times (the
    null block, by padding columns and idle rows) ends with the last write
    in row-major order, as the reference's scatter leaves it; torch's
    index_put_ alone leaves the winner undefined. An MoE's idle rows read
    that content. The megastep's shape: 8 rows of 256."""
    B, C, nb, blk = 8, 256, 3, 16
    rng = np.random.default_rng(5)
    bids = rng.integers(0, nb, (B, C))
    offs = rng.integers(0, blk, (B, C))
    k, v = rng.standard_normal((2, B, C, 2, 4)).astype(np.float32)
    pools = [torch.zeros((nb, blk, 2, 4)) for _ in range(2)]
    attention._write_pages(*pools, torch.from_numpy(bids),
                           torch.from_numpy(offs), torch.from_numpy(k),
                           torch.from_numpy(v))
    for got, new in zip(pools, (k, v)):
        want = jnp.zeros((nb, blk, 2, 4)).at[bids, offs].set(new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _models(**moe_kw):
    jcfg, tcfg = _cfgs(ARCH, **moe_kw)
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, _ = jax_build(jcfg).forward(params, {"tokens": jnp.asarray(toks)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_decode_matches_full_forward():
    """At capacity factor 8, as the reference's test: decode batches are
    tiny, so the capacity per call differs from the forward's unless
    routing is dropless."""
    _, _, tcfg, tp = _models(capacity_factor=8.0)
    model = build(tcfg)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(tcfg, b, s + 1, seed=2))
    ref = model.forward(tp, toks)
    state = model.init_decode_state(b, s + 4, device="cpu")
    for t in range(s):
        logits = model.decode_step(tp, state, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)
    state = model.init_decode_state(b, s + 4, device="cpu")
    last = model.prefill(tp, toks[:, :s], state=state)
    torch.testing.assert_close(last[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)
    nxt = model.decode_step(tp, state, toks[:, s:s + 1], s)
    torch.testing.assert_close(nxt[:, 0], ref[:, s], atol=2e-3, rtol=2e-3)


def _two_turns(eng):
    rids = [eng.submit(p, max_new_tokens=6, retain=True) for p in PROMPTS]
    eng.run_to_completion()
    out = [list(eng.reqs[r].out_tokens) for r in rids]
    for r in rids:
        eng.extend(r, np.arange(5) + 1, 4)
    eng.run_to_completion()
    return out + [list(eng.reqs[r].out_tokens) for r in rids]


def test_megastep_engine_matches_reference_engine(models):
    """Capacity factor 1.0: the megastep's padding columns and idle rows
    take expert slots, so equal tokens need the same flattening and
    grouping as the reference's."""
    jcfg, params, tcfg, tp = models
    want = _two_turns(JaxEngine(jcfg, params, **KW))
    eng = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    assert _two_turns(eng) == want
    assert eng.step_stats()["jit_dispatches_per_step"] == 1.0


def test_dense_engine_matches_reference_engine(models):
    jcfg, params, tcfg, tp = models

    def run(eng):
        rids = [eng.submit(p, max_new_tokens=6 + i)
                for i, p in enumerate(PROMPTS)]
        done = {r.rid: r.out_tokens for r in eng.run_to_completion()}
        return [done[r] for r in rids]

    want = run(JaxDense(jcfg, params, max_slots=2, max_len=64))
    assert run(InferenceEngine(tcfg, tp, max_slots=2, max_len=64,
                               device="cpu")) == want


def test_flat_width_keeps_the_padded_step(models, monkeypatch):
    jcfg, params, tcfg, tp = models
    B, C, blk, npages = 4, 16, 8, 6
    rng = np.random.default_rng(7)
    nb = B * npages + 1
    shape = (tcfg.n_layers, nb, blk, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    k, v = rng.standard_normal((2, *shape)).astype(np.float32)
    toks = _tokens(tcfg, B, C, seed=8)
    valids = np.array([0, 1, C // 2, C], np.int32)
    lens = np.array([0, 11, 5, npages * blk - C], np.int32)
    tables = rng.permutation(np.arange(1, nb)).reshape(B, npages).astype(
        np.int32)
    monkeypatch.setattr(attention, "flat_slots", None)   # never called
    runs = []
    for flat in (None, 16):
        pools = {"k": torch.from_numpy(k.copy()),
                 "v": torch.from_numpy(v.copy())}
        ids = ttr.mixed_step_paged(tp, pools, *map(torch.from_numpy, (
            toks, lens, valids, tables)), tcfg, flat=flat)
        runs.append((ids, pools))
    (want, want_pools), (got, got_pools) = runs
    assert torch.equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(got_pools[name], want_pools[name])
    jids, jpools = jax.jit(jtr.mixed_step_paged, static_argnames=("cfg",))(
        params, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        *map(jnp.asarray, (toks, lens, valids, tables)), cfg=jcfg)
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(jids)[1:])
    for name in ("k", "v"):
        np.testing.assert_allclose(got_pools[name].numpy()[:, 1:],
                                   np.asarray(jpools[name])[:, 1:],
                                   atol=1e-4, rtol=1e-4)
    eng = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    assert eng.flat_width == {c: 4 * c for c in eng.bucket_set}
    _two_turns(eng)
    assert eng.step_stats()["flat_steps"] == 0
