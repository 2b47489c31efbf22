"""The plain reference against the program at smoke sizes, on the CPU, for
both configurations' code paths (starcoder2-7b's plain GELU MLP and full
rotary; chatglm3-6b's SwiGLU, half rotary and 16:1-style grouping), in
float32 where both must agree to rounding."""
import json

import pytest
import torch

from agentbench import weights
from agentbench.kinds import dense
from agentbench.reference import model as ref
from agentbench.spec import PACKAGE
from agentbench.tests.tiny import TINY

from repro_torch.models import transformer as tr
from repro_torch.serving import PagedInferenceEngine
from repro_torch.weights import prepare_params


def tiny_conf(real: str, **over) -> dict:
    conf = json.loads((PACKAGE / "configs" / f"{real}.json").read_text())
    conf.update({k: v for k, v in TINY.items() if k != "engine"})
    conf.update(over)
    return conf


@pytest.fixture(params=["starcoder2-7b", "chatglm3-6b"])
def conf(request):
    return tiny_conf(request.param, torch_dtype="float32")


def test_reference_logits_match_the_port_forward(conf):
    m = ref.dims(conf)
    raw = weights.draw(m, dense.layer_groups(m), 123, "cpu",
                       torch.float32)
    cfg = dense.port_config(conf)
    params = prepare_params(raw, cfg, "cpu")
    toks = torch.randint(1, m["V"], (1, 40), generator=torch.Generator()
                         .manual_seed(5))
    want = tr.forward(params, toks, cfg)[0]
    got = ref.run(conf, raw, toks[0], torch.arange(40))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        float((got - want).abs().max())


def test_reference_kv_matches_the_megastep_pages(conf):
    """Prefill and decode through the program's megastep engine, then the
    pages read as the check reads them against the reference's K/V."""
    from agentbench import check
    m = ref.dims(conf)
    raw = weights.draw(m, dense.layer_groups(m), 7, "cpu",
                       torch.float32)
    cfg = dense.port_config(conf)
    eng = PagedInferenceEngine(cfg, prepare_params(raw, cfg, "cpu"),
                               num_blocks=64, block_size=16, max_batch=4,
                               max_len=256, token_budget=32, device="cpu")
    prompt = torch.randint(1, m["V"], (37,), generator=torch.Generator()
                           .manual_seed(9)).numpy()
    rid = eng.submit(prompt, max_new_tokens=5, retain=True)
    out = eng.run_to_completion()[0].out_tokens

    class Be:
        sessions = {"a": rid}
    k_pg, v_pg, n = check.copy_pages(eng, Be, "a")
    ids = torch.tensor(list(prompt) + out)
    assert n == len(ids) - 1
    kv = {}
    logits = ref.run(conf, raw, ids, torch.arange(len(prompt) - 1,
                                                  len(ids) - 1),
                     lambda li, k, v: kv.setdefault(li, (k, v)))
    assert logits.argmax(-1).tolist() == out
    for li, (k, v) in kv.items():
        assert torch.allclose(k_pg[li], k[:n], atol=1e-5)
        assert torch.allclose(v_pg[li], v[:n], atol=1e-5)


def test_rotation_leaves_the_unrotated_half():
    x = torch.randn(3, 2, 8)
    y = ref.rotate(x, torch.arange(3), 0.5, 10000.0)
    assert torch.equal(y[..., 4:], x[..., 4:])
    assert torch.equal(y[0], x[0])              # position 0: no rotation


def test_kv_pairings():
    assert ref.kv_index(8, 2, "g_major", "cpu").tolist() == [0, 1] * 4
    assert ref.kv_index(8, 2, "kv_major", "cpu").tolist() == [0] * 4 + [1] * 4


def test_a_sliding_window_changes_only_what_lies_beyond_it():
    conf = tiny_conf("starcoder2-7b", torch_dtype="float32")
    m = ref.dims(conf)
    raw = weights.draw(m, dense.layer_groups(m), 3, "cpu",
                       torch.float32)
    toks = torch.randint(1, m["V"], (40,), generator=torch.Generator()
                         .manual_seed(2))
    full = ref.run(dict(conf, sliding_window=None), raw, toks,
                   torch.arange(40))
    wide = ref.run(dict(conf, sliding_window=40), raw, toks,
                   torch.arange(40))
    short = ref.run(dict(conf, sliding_window=16), raw, toks,
                    torch.arange(40))
    assert torch.equal(wide, full)
    assert torch.equal(short[:16], full[:16])
    assert (short[16:] - full[16:]).abs().amax(-1).min() > 1e-3
