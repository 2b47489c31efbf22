"""The port's MLA (``attention.mla_full`` / ``mla_decode``) and the
deepseek-v2-lite family (MLA, MoE, a leading dense layer) against the
reference on the CPU, at float32, weights from the reference's
initialisation:

  * ``mla_full`` (and its cache entries) and ``mla_decode`` (and the
    latent caches it writes) within 1e-5 of the reference's;
  * deepseek-v2-lite smoke: ``forward`` logits within 1e-4; ``prefill``'s
    caches (``dense0``'s ``ckv0``/``krope0`` apart) and greedy
    ``decode_step``s against the reference's; the reference's
    test_decode_matches_full_forward on the port at capacity factor 8;
  * no engine serves MLA: both port engines and the paged pools raise
    ``NotImplementedError``, and the reference's ``InferenceEngine`` is
    shown to fail on it at its first decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import build as jax_build
from repro.models import transformer as jtr
from repro.serving import InferenceEngine as JaxDense
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, build
from repro_torch.models.transformer import init_paged_pools
from repro_torch.serving import InferenceEngine, PagedInferenceEngine
from repro_torch.weights import numpy_to_torch, params_from_jax

ARCH = "deepseek-v2-lite-16b"


def _cfgs(cf=None):
    jcfg = jax_smoke(ARCH).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(remat=False,
                                          compute_dtype="float32")
    if cf is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cf))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=cf))
    return jcfg, tcfg


def _models(cf=None):
    jcfg, tcfg = _cfgs(cf)
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


def test_mla_full_and_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    tp = {k: numpy_to_torch(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    b, s, S = 2, 12, 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    want, (jckv, jkr) = jattn.mla_full(jp, jnp.asarray(x), jcfg,
                                       return_kv=True)
    got, (ckv, kr) = attention.mla_full(tp, torch.from_numpy(x), tcfg,
                                        return_kv=True)
    for g, w in ((got, want), (ckv, jckv), (kr, jkr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    m = jcfg.mla
    cache = rng.standard_normal((b, S, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((b, S, m.qk_rope_head_dim)).astype(
        np.float32)
    x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    want, (jc, jk) = jattn.mla_decode(jp, jnp.asarray(x1), jnp.asarray(cache),
                                      jnp.asarray(krope), 9, jcfg)
    tc, tk = torch.from_numpy(cache.copy()), torch.from_numpy(krope.copy())
    got = attention.mla_decode(tp, torch.from_numpy(x1), tc, tk, 9, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    with pytest.raises(ValueError, match="scalar cache_len"):
        attention.mla_decode(tp, torch.from_numpy(x1), tc, tk,
                             torch.tensor([3, 4], dtype=torch.int32), tcfg)


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    assert "dense0" in tp and len(tp["layers"]) == jcfg.n_layers - 1
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, _ = jax_build(jcfg).forward(params, {"tokens": jnp.asarray(toks)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_prefill_state_and_greedy_decode_match_reference(models):
    """Prefill fills the reference's latent caches (dense0's apart), then
    6 greedy decode steps give its logits and tokens."""
    jcfg, params, tcfg, tp = models
    b, s, steps = 2, 8, 6
    toks = _tokens(jcfg, b, s, seed=3)
    jstate = jax_build(jcfg).init_decode_state(b, s + steps)
    jlast, jstate = jtr.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                                jstate)
    model = build(tcfg)
    state = model.init_decode_state(b, s + steps, device="cpu")
    assert sorted(state) == sorted(jstate)
    last = model.prefill(tp, torch.from_numpy(toks), state=state)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)
    for name in state:
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=1e-5,
                                   rtol=1e-5)
    jstep = jax.jit(jax_build(jcfg).decode_step)
    jtok = jnp.argmax(jlast[:, -1], -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    for t in range(steps):
        jlogits, jstate = jstep(params, jstate, jtok, jnp.int32(s + t))
        logits = model.decode_step(tp, state, tok, s + t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_decode_matches_full_forward():
    _, _, tcfg, tp = _models(cf=8.0)
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
    model.prefill(tp, toks[:, :s], state=state)
    nxt = model.decode_step(tp, state, toks[:, s:s + 1], s)
    torch.testing.assert_close(nxt[:, 0], ref[:, s], atol=2e-3, rtol=2e-3)


def test_no_engine_serves_mla(models):
    """The port refuses MLA at construction, naming the reference's gap;
    the reference's InferenceEngine admits it and fails at the first
    decode step (per-slot lengths into mla_decode's scalar position)."""
    jcfg, params, tcfg, tp = models
    for make in (lambda: InferenceEngine(tcfg, tp, device="cpu"),
                 lambda: PagedInferenceEngine(tcfg, tp, device="cpu"),
                 lambda: PagedInferenceEngine(tcfg, tp, device="cpu",
                                              megastep=False),
                 lambda: init_paged_pools(tcfg, 8, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="MLA"):
            make()
    with pytest.raises(NotImplementedError, match="mla is None"):
        build(tcfg).mixed_step_paged(tp, None, None, None, None, None)
    jeng = JaxDense(jcfg, params, max_slots=2, max_len=32)
    jeng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="shapes"):
        jeng.step()
