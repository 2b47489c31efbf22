"""The port's SSM family (mamba2-370m smoke, Mamba-2 blocks only) against
the reference on the CPU, at float32, both sides from the reference's
``init_params(PRNGKey(0))``:

  * teacher-forced ``forward`` logits within 1e-4;
  * ``prefill``'s decode state (each layer's conv window and SSD state)
    within 1e-5;
  * ``prefill`` + ``decode_step`` logits within 1e-4, and greedy tokens
    equal over 8 steps;
  * the reference's test_decode_matches_full_forward on the port:
    ``decode_step`` fed token by token against the port's own ``forward``,
    within 2e-3;
  * the paged members and both serving engines refuse the family, as the
    reference's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke_config
from repro_torch.models import build
from repro_torch.models.transformer import init_paged_pools
from repro_torch.serving import InferenceEngine, PagedInferenceEngine
from repro_torch.weights import params_from_jax

ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(remat=False,
                                          compute_dtype="float32")
    params = jax.jit(jax_build(jcfg).init_params)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    toks = _tokens(jcfg, 2, 16, seed=1)
    want, _ = jax.jit(jax_build(jcfg).forward)(
        params, {"tokens": jnp.asarray(toks)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_prefill_state_and_greedy_decode_match_reference(models):
    """Prefill fills the same state; then 8 greedy decode steps give the
    reference's logits (1e-4) and tokens."""
    jcfg, params, tcfg, tp = models
    b, s, steps = 2, 8, 8
    toks = _tokens(jcfg, b, s, seed=3)
    jstate = jax_build(jcfg).init_decode_state(b, s + steps)
    jlast, jstate = jtr.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                                jstate)
    model = build(tcfg)
    state = model.init_decode_state(b, s + steps, device="cpu")
    last = model.prefill(tp, torch.from_numpy(toks), state=state)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)
    for name in ("conv", "ssm"):
        assert tuple(state[name].shape) == jstate[name].shape
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=1e-5,
                                   rtol=1e-5)
    jstep = jax.jit(jax_build(jcfg).decode_step)
    jtok = jnp.argmax(jlast[:, -1], -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    jtoks, ttoks = [], []
    for t in range(steps):
        jlogits, jstate = jstep(params, jstate, jtok, jnp.int32(s + t))
        logits = model.decode_step(tp, state, tok, s + t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        jtoks.append(np.asarray(jtok))
        ttoks.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))


def test_decode_matches_full_forward(models):
    """The reference's own check on the port: decode token by token, and
    prefill + decode, against forward, at 2e-3. Forward and prefill run
    whole chunks (s = 16, p = 8 with the smoke chunk of 8)."""
    _, _, tcfg, tp = models
    model = build(tcfg)
    b, s, p = 2, 16, 8
    toks = torch.from_numpy(_tokens(tcfg, b, s, seed=2))
    ref = model.forward(tp, toks)
    state = model.init_decode_state(b, s, device="cpu")
    for t in range(s):
        logits = model.decode_step(tp, state, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)
    state = model.init_decode_state(b, s, device="cpu")
    last = model.prefill(tp, toks[:, :p], state=state)
    torch.testing.assert_close(last[:, 0], ref[:, p - 1], atol=2e-3,
                               rtol=2e-3)
    for t in range(p, s):
        nxt = model.decode_step(tp, state, toks[:, t:t + 1], t)
    torch.testing.assert_close(nxt[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)


def test_paged_members_and_engines_refuse_the_family(models):
    _, _, tcfg, tp = models
    model = build(tcfg)
    with pytest.raises(NotImplementedError, match="paged"):
        model.mixed_step_paged(tp, None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="GQA"):
        init_paged_pools(tcfg, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="GQA"):
        InferenceEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="GQA"):
        PagedInferenceEngine(tcfg, tp, device="cpu")
