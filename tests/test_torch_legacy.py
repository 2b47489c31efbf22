"""The port's legacy paged loop (``PagedInferenceEngine(megastep=False)``,
the benchmark baseline) against the reference on the CPU at float32, on
gemma-2b smoke (MQA) and chatglm3-6b smoke (GQA hq4/hkv2):

  * ``decode_step_paged`` and ``prefill_chunk_paged`` give the reference's
    logits within 1e-4 and pools within 1e-5;
  * the legacy engine gives the reference legacy engine's tokens over two
    turns, at 1 + n_prefilling calls per step;
  * the port's legacy and megastep engines agree token for token (the
    reference's test_megastep_matches_legacy_tokens_at_f32);
  * ``SerializedPagedBackend`` under AgentRM completes every turn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro.models import transformer as jtr
from repro.serving import PagedInferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import AgentRM, AgentRMConfig
from repro_torch.models import transformer as ttr
from repro_torch.serving import PagedInferenceEngine, SerializedPagedBackend
from repro_torch.weights import params_from_jax

KW = dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
          prefill_chunk=8)
BLK, NPAGES, B = 8, 6, 3


@pytest.fixture(scope="module", params=["gemma-2b", "chatglm3-6b"])
def models(request):
    arch = request.param
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(remat=False,
                                          compute_dtype="float32")
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B * NPAGES + 1, BLK, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    tables = rng.permutation(np.arange(1, B * NPAGES + 1)).reshape(
        B, NPAGES).astype(np.int32)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), tables, rng)


def _close_pools(tpools, jpools):
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy(),
                                   np.asarray(jpools[name]), atol=1e-5,
                                   rtol=1e-5)


def test_decode_step_paged_matches_reference(models):
    jcfg, params, tcfg, tp = models
    k, v, tables, rng = _pools(jcfg, seed=3)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.array([0, 13, NPAGES * BLK - 1], np.int32)
    want, jpools = jtr.decode_step_paged(
        params, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(tok),
        jnp.asarray(lens), jnp.asarray(tables), jcfg)
    tpools = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got = ttr.decode_step_paged(tp, tpools, torch.from_numpy(tok),
                                torch.from_numpy(lens),
                                torch.from_numpy(tables), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _close_pools(tpools, jpools)


@pytest.mark.parametrize("cache_len,valid", [(0, 8), (13, 5), (24, 1)])
def test_prefill_chunk_paged_matches_reference(models, cache_len, valid):
    """A chunk of width 8 at a page-aligned, a ragged and a one-token
    offset; padding positions write to the null block 0."""
    jcfg, params, tcfg, tp = models
    k, v, tables, rng = _pools(jcfg, seed=cache_len)
    toks = rng.integers(0, jcfg.vocab_size, (1, 8)).astype(np.int32)
    want, jpools = jtr.prefill_chunk_paged(
        params, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(toks), jnp.int32(cache_len), jnp.int32(valid),
        jnp.asarray(tables[1]), jcfg)
    tpools = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got = ttr.prefill_chunk_paged(tp, tpools, torch.from_numpy(toks),
                                  cache_len, valid,
                                  torch.from_numpy(tables[1]), tcfg)
    np.testing.assert_allclose(got.numpy()[:, :valid],
                               np.asarray(want)[:, :valid], atol=1e-4,
                               rtol=1e-4)
    # block 0 takes every padding write, in an order neither side fixes
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:, 1:],
                                   np.asarray(jpools[name])[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def _two_turns(eng):
    rids = [eng.submit(np.arange(5 + 7 * i) % 50, max_new_tokens=6,
                       retain=True) for i in range(3)]
    eng.run_to_completion()
    for r in rids:
        eng.extend(r, [3, 4, 5], max_new_tokens=4)
    eng.run_to_completion()
    return {r: list(eng.reqs[r].out_tokens) for r in rids}


def test_legacy_engine_matches_reference(models):
    jcfg, params, tcfg, tp = models
    want = _two_turns(JaxEngine(jcfg, params, megastep=False, **KW))
    eng = PagedInferenceEngine(tcfg, tp, megastep=False, device="cpu", **KW)
    eng.compile_buckets()                    # a no-op for the legacy loop
    assert not eng.compiled_buckets
    assert _two_turns(eng) == want
    assert eng.jit_dispatches_per_step > 1.0


def test_legacy_matches_megastep_tokens(models):
    _, _, tcfg, tp = models
    legacy = _two_turns(PagedInferenceEngine(tcfg, tp, megastep=False,
                                             device="cpu", **KW))
    mega = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    assert _two_turns(mega) == legacy
    assert mega.jit_dispatches_per_step == 1.0


def test_serialized_backend_completes_every_turn(models):
    _, _, tcfg, tp = models
    eng = PagedInferenceEngine(tcfg, tp, megastep=False, device="cpu", **KW)
    backend = SerializedPagedBackend(eng, max_new_tokens=5, prompt_tokens=20)
    rm = AgentRM(backend, AgentRMConfig(detect_after_s=120.0))
    try:
        for turn in range(2):
            hs = [rm.submit(f"agent{a}", f"turn {turn} of agent {a}")
                  for a in range(3)]
            outs = [h.result(120) for h in hs]
            assert all(len(o[len("tok:"):].split(",")) == 5 for o in outs)
    finally:
        rm.shutdown()
    assert len(backend.sessions) == 3 and not eng.active
