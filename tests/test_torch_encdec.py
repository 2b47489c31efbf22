"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-tiny
smoke) against ``repro.models.encdec`` on the CPU, at float32, weights from
the reference's initialisation:

  * ``encode`` within 1e-5, ``forward`` logits within 1e-4;
  * ``init_cross_cache`` (every layer's cross K/V) within 1e-5, then
    ``decode_step``s with the reference's logits and greedy tokens;
  * decode against forward within 2e-3 (the reference's
    test_decode_matches_full_forward);
  * the engines and the missing members refuse the family, as the
    reference's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro.models import encdec as jenc
from repro_torch.configs import get_smoke_config
from repro_torch.models import build, encdec
from repro_torch.serving import InferenceEngine, PagedInferenceEngine
from repro_torch.weights import params_from_jax

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(remat=False,
                                          compute_dtype="float32")
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.enc_len, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


def test_encode_and_forward_match_reference(models):
    jcfg, params, tcfg, tp = models
    assert len(tp["enc_layers"]) == jcfg.n_enc_layers
    toks, frames = _inputs(jcfg, 2, 12, seed=1)
    want = jenc.encode(params, jnp.asarray(frames), jcfg)
    got = encdec.encode(tp, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want, _ = jax_build(jcfg).forward(params, {
        "tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks),
                              frame_embeds=torch.from_numpy(frames))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_cross_cache_and_greedy_decode_match_reference(models):
    jcfg, params, tcfg, tp = models
    b, steps = 2, 8
    _, frames = _inputs(jcfg, b, 1, seed=3)
    jck, jcv = jenc.init_cross_cache(params, jnp.asarray(frames), jcfg)
    ck, cv = encdec.init_cross_cache(tp, torch.from_numpy(frames), tcfg)
    for g, w in ((ck, jck), (cv, jcv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    jstate = dict(jax_build(jcfg).init_decode_state(b, steps),
                  cross_k=jck, cross_v=jcv)
    model = build(tcfg)
    state = model.init_decode_state(b, steps, device="cpu")
    assert sorted(state) == sorted(jstate)
    state["cross_k"], state["cross_v"] = ck, cv
    jstep = jax.jit(jax_build(jcfg).decode_step)
    jtok = jnp.ones((b, 1), jnp.int32)
    tok = torch.ones((b, 1), dtype=torch.int32)
    for t in range(steps):
        jlogits, jstate = jstep(params, jstate, jtok, jnp.int32(t))
        logits = model.decode_step(tp, state, tok, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for name in ("k", "v"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=1e-5,
                                   rtol=1e-5)


def test_decode_matches_full_forward(models):
    _, _, tcfg, tp = models
    model = build(tcfg)
    b, s = 2, 16
    toks, frames = _inputs(tcfg, b, s, seed=2)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    ref = model.forward(tp, toks, frame_embeds=frames)
    state = model.init_decode_state(b, s, device="cpu")
    state["cross_k"], state["cross_v"] = encdec.init_cross_cache(tp, frames,
                                                                 tcfg)
    for t in range(s):
        logits = model.decode_step(tp, state, toks[:, t:t + 1], t)
        torch.testing.assert_close(logits[:, 0], ref[:, t], atol=2e-3,
                                   rtol=2e-3)


def test_engines_and_missing_members_refuse(models):
    _, _, tcfg, tp = models
    model = build(tcfg)
    for make in (lambda: InferenceEngine(tcfg, tp, device="cpu"),
                 lambda: PagedInferenceEngine(tcfg, tp, device="cpu")):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            make()
    for member in ("prefill", "decode_step_paged", "prefill_chunk_paged",
                   "mixed_step_paged"):
        with pytest.raises(NotImplementedError, match=member):
            getattr(model, member)(tp)
    with pytest.raises(ValueError, match="scalar cache_len"):
        model.decode_step(tp, model.init_decode_state(2, 4, device="cpu"),
                          torch.ones((2, 1), dtype=torch.int32),
                          torch.tensor([0, 1], dtype=torch.int32))
