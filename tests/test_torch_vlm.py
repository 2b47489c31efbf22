"""The VLM family (llava-next, an image-token prefix) and starcoder2 (GQA,
a plain GELU MLP) against the reference on the CPU, at float32, weights
from the reference's initialisation:

  * ``forward`` logits within 1e-4, llava's given ``patch_embeds`` and
    over its text positions only;
  * llava's ``prefill`` with the prefix: last logits within 1e-4, the K/V
    cache of image and text positions within 1e-5, then greedy
    ``decode_step``s with the reference's logits and tokens; decode
    against forward within 2e-3;
  * the megastep (text only for llava, as the reference's paged members
    are): the port's ``PagedInferenceEngine`` gives the reference
    engine's tokens.
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
from repro_torch.models import build
from repro_torch.serving import PagedInferenceEngine
from repro_torch.weights import params_from_jax

VLM = "llava-next-mistral-7b"
ARCHS = [VLM, "starcoder2-7b"]
KW = dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
          token_budget=16)
PROMPTS = [np.arange(9) % 50, (np.arange(30) + 3) % 200,
           (np.arange(17) * 7) % 256]


def _models(arch):
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(remat=False,
                                          compute_dtype="float32")
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def llava():
    return _models(VLM)


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patch = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model)) \
        .astype(np.float32) if cfg.family == "vlm" else None
    return toks, patch


def _batches(toks, patch):
    """The reference's batch dict and the port's keyword inputs."""
    jb, kw = {"tokens": jnp.asarray(toks)}, {}
    if patch is not None:
        jb["patch_embeds"] = jnp.asarray(patch)
        kw["patch_embeds"] = torch.from_numpy(patch)
    return jb, kw


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    toks, patch = _inputs(jcfg, 2, 24, seed=1)
    jb, kw = _batches(toks, patch)
    want, _ = jax_build(jcfg).forward(params, jb)
    got = build(tcfg).forward(tp, torch.from_numpy(toks), **kw)
    assert got.shape == want.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_vlm_needs_patch_embeds(llava):
    tp, tcfg = llava[3], llava[2]
    with pytest.raises(ValueError, match="patch_embeds"):
        build(tcfg).forward(tp, torch.zeros((1, 4), dtype=torch.int32))


def test_prefill_with_prefix_and_greedy_decode_match_reference(llava):
    jcfg, params, tcfg, tp = llava
    b, s, steps = 2, 10, 6
    n = s + jcfg.n_image_tokens
    toks, patch = _inputs(jcfg, b, s, seed=3)
    jb, kw = _batches(toks, patch)
    jstate = jax_build(jcfg).init_decode_state(b, n + steps)
    jlast, jstate = jtr.prefill(params, jb, jcfg, jstate)
    model = build(tcfg)
    state = model.init_decode_state(b, n + steps, device="cpu")
    last = model.prefill(tp, torch.from_numpy(toks), state=state, **kw)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=1e-5,
                                   rtol=1e-5)
    jstep = jax.jit(jax_build(jcfg).decode_step)
    jtok = jnp.argmax(jlast[:, -1], -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    for t in range(steps):
        jlogits, jstate = jstep(params, jstate, jtok, jnp.int32(n + t))
        logits = model.decode_step(tp, state, tok, n + t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_decode_matches_full_forward(models):
    """The text decodes token by token after the prefix (a VLM) or from
    position 0, against the port's own forward, within 2e-3."""
    _, _, tcfg, tp = models
    model = build(tcfg)
    b, s = 2, 12
    toks, patch = _inputs(tcfg, b, s + 1, seed=2)
    _, kw = _batches(toks, patch)
    toks = torch.from_numpy(toks)
    ref = model.forward(tp, toks, **kw)
    n = tcfg.n_image_tokens if patch is not None else 0
    state = model.init_decode_state(b, n + s + 4, device="cpu")
    if patch is not None:
        model.prefill(tp, toks[:, :1], state=state, **kw)
        start = 1
    else:
        start = 0
    for t in range(start, s):
        logits = model.decode_step(tp, state, toks[:, t:t + 1], n + t)
    torch.testing.assert_close(logits[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)


def _two_turns(eng):
    rids = [eng.submit(p, max_new_tokens=6, retain=True) for p in PROMPTS]
    eng.run_to_completion()
    out = [list(eng.reqs[r].out_tokens) for r in rids]
    for r in rids:
        eng.extend(r, np.arange(5) + 1, 4)
    eng.run_to_completion()
    return out + [list(eng.reqs[r].out_tokens) for r in rids]


def test_megastep_engine_matches_reference_engine(models):
    jcfg, params, tcfg, tp = models
    want = _two_turns(JaxEngine(jcfg, params, **KW))
    eng = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    assert _two_turns(eng) == want
    assert eng.step_stats()["jit_dispatches_per_step"] == 1.0
