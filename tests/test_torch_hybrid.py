"""The port's hybrid (zamba2-7b smoke: two groups of [shared attention
block, two Mamba-2 layers] and one tail layer) against the reference on the
CPU, at float32, both sides from the reference's ``init_params(PRNGKey(0))``:

  * teacher-forced ``forward`` logits within 1e-4;
  * ``decode_step`` fed token by token from position 0 (the reference's
    hybrid has no prefill) within 1e-4 of the reference's at every step;
  * the reference's test_decode_matches_full_forward on the port, 2e-3;
  * with ``attn_window=8`` the ring buffers wrap past position 8, and each
    step still matches the reference's ``decode_step`` within 1e-4;
  * ``prefill`` and the paged members raise, as the reference has none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.models import build
from repro_torch.serving import InferenceEngine
from repro_torch.weights import params_from_jax

ARCH = "zamba2-7b"


def _models(**over):
    jcfg = jax_smoke(ARCH).replace(remat=False, compute_dtype="float32",
                                   **over)
    tcfg = get_smoke_config(ARCH).replace(remat=False,
                                          compute_dtype="float32", **over)
    params = jax.jit(jax_build(jcfg).init_params)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_keep_the_layout(models):
    _, _, tcfg, tp = models
    assert len(tp["groups"]) == 2 and all(len(g) == 2 for g in tp["groups"])
    assert len(tp["tail"]) == 1 and "wq" in tp["shared"]["attn"]


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    toks = _tokens(jcfg, 2, 16, seed=1)
    want, _ = jax.jit(jax_build(jcfg).forward)(
        params, {"tokens": jnp.asarray(toks)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _decode_both(jcfg, params, tcfg, tp, toks, max_len):
    """Both decode_steps fed ``toks`` (b, s) token by token from position
    0, the logits held within 1e-4 at every step; returns the port's last
    logits."""
    b, s = toks.shape
    jmodel, model = jax_build(jcfg), build(tcfg)
    jstep = jax.jit(jmodel.decode_step)
    jstate = jmodel.init_decode_state(b, max_len)
    state = model.init_decode_state(b, max_len, device="cpu")
    for t in range(s):
        jlogits, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        logits = model.decode_step(tp, state, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
    for name, arr in jstate.items():
        np.testing.assert_allclose(state[name].numpy(), np.asarray(arr),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    return logits


def test_decode_step_matches_reference(models):
    jcfg, params, tcfg, tp = models
    _decode_both(jcfg, params, tcfg, tp, _tokens(jcfg, 2, 10, seed=4),
                 max_len=12)


def test_ring_decode_wraps_like_the_reference():
    """A window of 8 slots: positions 8.. overwrite the ring from slot 0."""
    jcfg, params, tcfg, tp = _models(attn_window=8)
    state = build(tcfg).init_decode_state(2, 32, device="cpu")
    assert state["attn_k"].shape[2] == 8
    _decode_both(jcfg, params, tcfg, tp, _tokens(jcfg, 2, 14, seed=5),
                 max_len=32)


def test_decode_matches_full_forward(models):
    """The reference's own check on the port, at 2e-3."""
    _, _, tcfg, tp = models
    model = build(tcfg)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(tcfg, b, s, seed=2))
    ref = model.forward(tp, toks)
    state = model.init_decode_state(b, s + 4, device="cpu")
    for t in range(s):
        logits = model.decode_step(tp, state, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], ref[:, s - 1], atol=2e-3,
                               rtol=2e-3)


def test_members_the_reference_lacks_raise(models):
    _, _, tcfg, tp = models
    model = build(tcfg)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="prefill"):
        model.prefill(tp, toks, state={})
    with pytest.raises(NotImplementedError, match="paged"):
        model.decode_step_paged(tp, None, toks, None, None)
    with pytest.raises(NotImplementedError, match="GQA"):
        InferenceEngine(tcfg, tp, device="cpu")
