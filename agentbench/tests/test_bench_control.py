"""``correct`` comes out false for the control and for each fault a cell can
have, with the rest of a run driven as the command drives it (here on the
CPU, at smoke sizes, skipping the look for a card).

The control is the program's own lower precision: its fp8 KV cache
(``kv_cache_dtype="float8_e4m3fn"``) against the bf16 the configurations
state. The faults are planted in the timed path underneath: a step that
leaves its state (the pool) unchanged; half of the batch left out (its
tokens' pages never written); a token altered where the step produces it,
one row a step; an answer altered where AgentRM's backend hands it over.
These cells run on one chip, so there is no exchange between chips to
leave out.
"""
import json

import pytest
import torch

from agentbench import run
from agentbench.tests.tiny import make_tree

from repro_torch.models import attention, transformer
from repro_torch.serving import backend


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def result(tree, capsys, cell="tiny-sc2-fleet", seed=2147483999,
           conf_over=None):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "1.5", "--trace", "0"], device="cpu", root=tree,
                  conf_over=conf_over)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny-sc2-fleet", "tiny-glm3-fleet",
                                  "tiny-sc2-decode", "tiny-glm3-decode"])
def test_sound_runs_are_correct(tree, capsys, cell):
    out = result(tree, capsys, cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", ["tiny-sc2-fleet", "tiny-glm3-fleet"])
def test_the_fp8_kv_control_is_not_correct(tree, capsys, cell):
    out = result(tree, capsys, cell,
                 conf_over={"kv_cache_dtype": "float8_e4m3fn"})
    assert out["correct"] is False
    assert out["checks"]["kv_rel_err"]["value"] > \
        out["checks"]["kv_rel_err"]["limit"]


def test_a_step_that_leaves_the_pool_unchanged(tree, capsys, monkeypatch):
    monkeypatch.setattr(attention, "_write_pages", lambda *a, **k: None)
    out = result(tree, capsys)
    assert out["correct"] is False
    assert out["checks"]["kv_rel_err"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tree, capsys, monkeypatch):
    real = transformer.mixed_step_paged

    def half(params, pools, tokens, lens, valids, tables, cfg, *a, **k):
        valids = valids.clone()
        valids[valids.shape[0] // 2:] = 0
        return real(params, pools, tokens, lens, valids, tables, cfg, *a,
                    **k)
    monkeypatch.setattr(transformer, "mixed_step_paged", half)
    out = result(tree, capsys, "tiny-sc2-decode")
    assert out["correct"] is False
    assert out["checks"]["kv_tokens_unwritten"]["value"] > 0


def test_a_token_altered_where_it_is_produced(tree, capsys, monkeypatch):
    """One row's sampled token a step is altered, the row turning with
    the steps, so that every session gets wrong tokens."""
    real = transformer.mixed_step_paged
    calls = []

    def altered(*a, **k):
        ids = real(*a, **k)
        cfg = a[6]
        calls.append(None)
        row = len(calls) % ids.shape[0]
        return torch.where(torch.arange(ids.shape[0]) == row,
                           (ids + 1) % cfg.vocab_size, ids).to(ids.dtype)
    monkeypatch.setattr(transformer, "mixed_step_paged", altered)
    out = result(tree, capsys)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_an_answer_altered_where_it_is_handed_over(tree, capsys,
                                                    monkeypatch):
    real = backend.PagedEngineBackend.collect

    def altered(self, rid):
        text = real(self, rid)
        return text[:-1] + ("1" if text[-1] != "1" else "2")
    monkeypatch.setattr(backend.PagedEngineBackend, "collect", altered)
    out = result(tree, capsys)
    assert out["correct"] is False
    assert out["checks"]["delivery_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny-sc2-fleet", "tiny-glm3-fleet"])
def test_the_fp8_reference_control_fails_the_logit_gap(tree, cell):
    """The reference computed in fp8, read at the same prompts and tokens,
    puts first tokens whose gap fails ``logit_gap``'s limit, where the
    program's own fp8 cache barely moves it."""
    from agentbench.spec import Cell
    c = Cell(cell, tree)
    out = run.execute(c, 5, 1.5, False, torch.device("cpu"),
                      reference_control=True)
    assert out["numbers"]["logit_gap"] <= c.limits["logit_gap"]
    assert out["numbers"]["control_logit_gap"] > c.limits["logit_gap"]


def test_a_windowed_model_stops_each_session_at_its_window(tree, capsys):
    """The decode sessions would outgrow the window; the client stops each
    before its tokens pass it, and the run is correct against the
    reference, which applies the window."""
    from agentbench.tests.tiny import WINDOW
    rc = run.main(["--workload", "tiny-sc2-window-decode", "--seed", "77",
                   "--seconds", "1.5", "--trace", "0"], device="cpu",
                  root=tree)
    assert rc == 0
    got = capsys.readouterr()
    out = json.loads(got.out.strip().splitlines()[-1])
    info = next(json.loads(line) for line in got.err.splitlines()
                if line.startswith("{") and "capped_sessions" in line)
    assert info["capped_sessions"] == 4
    assert out["correct"] is True, out["checks"]
    assert 0 < info["pool_pages_peak"] <= 4 * WINDOW // 16
