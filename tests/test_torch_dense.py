"""The port's model API and dense slot engine against the reference on the
CPU, at float32, on gemma-2b smoke (MQA, hq4/hkv1) and chatglm3-6b smoke
(GQA hq4/hkv2, partial rotary, untied head):

  * teacher-forced ``forward`` logits within 1e-4 of the reference's;
  * the port's decode realises the same model as its forward: ``decode_step``
    fed token by token at a scalar ``cache_len`` gives the last position's
    logits within 2e-3 (the reference's own check,
    test_decode_matches_full_forward), and ``prefill`` into a decode state
    followed by ``decode_step`` does too;
  * ``InferenceEngine`` gives the reference engine's tokens;
  * ``EngineBackend`` under AgentRM completes every turn;
  * a JAX ``extract_slot`` payload restores into the port and continues
    with the reference's tokens, and a bf16 payload crosses both ways bit
    for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build as jax_build
from repro.serving import InferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import AgentRM, AgentRMConfig
from repro_torch.models import build
from repro_torch.serving import EngineBackend, InferenceEngine
from repro_torch.weights import params_from_jax, slot_payload_as

ARCHS = ["gemma-2b", "chatglm3-6b"]
PROMPTS = [np.arange(9) % 50, (np.arange(30) + 3) % 200,
           (np.arange(17) * 7) % 256]


def _models(arch, dtype="float32"):
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype=dtype)
    tcfg = get_smoke_config(arch).replace(remat=False, compute_dtype=dtype)
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_match_reference(models):
    jcfg, params, tcfg, tp = models
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, _ = jax_build(jcfg).forward(params, {"tokens": jnp.asarray(toks)})
    got = build(tcfg).forward(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_decode_matches_full_forward(models):
    """Lockstep decode (scalar cache_len) and prefill + decode against the
    port's own forward, at the reference test's 2e-3."""
    _, _, tcfg, tp = models
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


def _run_engine(eng):
    rids = [eng.submit(p, max_new_tokens=6 + i) for i, p in
            enumerate(PROMPTS)]
    done = {r.rid: r.out_tokens for r in eng.run_to_completion()}
    return [done[r] for r in rids]


def test_engine_matches_reference_engine(models):
    """Three prompts through two slots: the third waits for a free slot,
    so admission, per-slot lengths and idle slots are all exercised."""
    jcfg, params, tcfg, tp = models
    want = _run_engine(JaxEngine(jcfg, params, max_slots=2, max_len=64))
    eng = InferenceEngine(tcfg, tp, max_slots=2, max_len=64, device="cpu")
    assert _run_engine(eng) == want
    assert eng.jit_dispatches_per_step > 1.0


def test_engine_backend_completes_every_turn(models):
    _, _, tcfg, tp = models
    eng = InferenceEngine(tcfg, tp, max_slots=4, max_len=128, device="cpu")
    rm = AgentRM(EngineBackend(eng, max_new_tokens=5),
                 AgentRMConfig(detect_after_s=120.0))
    try:
        for turn in range(2):
            hs = [rm.submit(f"agent{a}", f"turn {turn} of agent {a}")
                  for a in range(3)]
            outs = [h.result(120) for h in hs]
            assert all(len(o[len("tok:"):].split(",")) == 5 for o in outs)
    finally:
        rm.shutdown()
    assert not eng.active and len(eng.free_slots) == 4


def test_jax_slot_payload_continues_in_port(models):
    """The JAX engine's slot, taken mid-decode, replaces the port's own at
    the same point; the port then finishes with the JAX engine's tokens."""
    jcfg, params, tcfg, tp = models
    jeng = JaxEngine(jcfg, params, max_slots=1, max_len=64)
    jrid = jeng.submit(PROMPTS[1], max_new_tokens=10)
    eng = InferenceEngine(tcfg, tp, max_slots=1, max_len=64, device="cpu")
    rid = eng.submit(PROMPTS[1], max_new_tokens=10)
    for _ in range(3):
        jeng.step()
        eng.step()
    payload, length = jeng.extract_slot(jeng.active[jrid].slot)
    mine, my_length = eng.extract_slot(eng.active[rid].slot)
    assert length == my_length
    for name in ("k", "v"):
        np.testing.assert_allclose(mine[name], payload[name], atol=1e-5,
                                   rtol=1e-5)
    eng.restore_slot(eng.active[rid].slot,
                     slot_payload_as(payload, np.uint16), length)
    want = {r.rid: r.out_tokens for r in jeng.run_to_completion()}[jrid]
    assert {r.rid: r.out_tokens
            for r in eng.run_to_completion()}[rid] == want


def test_bf16_slot_payload_crosses_both_ways_bit_for_bit():
    jcfg, params, tcfg, tp = _models("gemma-2b", "bfloat16")
    jeng = JaxEngine(jcfg, params, max_slots=2, max_len=32)
    jeng.submit(PROMPTS[0], max_new_tokens=4)
    jeng.step()
    payload, length = jeng.extract_slot(0)
    assert payload["k"].dtype == jnp.bfloat16
    eng = InferenceEngine(tcfg, tp, max_slots=2, max_len=32, device="cpu")
    eng.restore_slot(1, slot_payload_as(payload, np.uint16), length)
    back, back_len = eng.extract_slot(1)
    assert back["k"].dtype == np.uint16 and back_len == length
    jeng.restore_slot(1, slot_payload_as(back, jnp.bfloat16), back_len)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            back[name], np.asarray(payload[name]).view(np.uint16))
        np.testing.assert_array_equal(
            np.asarray(jeng.state[name][:, 1]).view(np.uint16),
            np.asarray(payload[name]).view(np.uint16))
