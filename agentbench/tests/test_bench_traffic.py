"""The generator, the cells' sizing, and that a new cell, mix and metric
are found by name with no edit to a file that exists."""
import copy
import json
import math
from collections import Counter

import numpy as np
import pytest

from agentbench import traffic
from agentbench.spec import PACKAGE, ROOT, Cell, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_same_seed_same_sessions_other_seed_same_sizes():
    mix = Cell("sc2-agent-fleet").traffic
    a = traffic.sessions(mix, 2147483999, 66.0)
    b = traffic.sessions(mix, 2147483999, 66.0)
    c = traffic.sessions(mix, 5, 66.0)
    assert [(s.agent_id, s.arrival_s, s.prompts, s.think_s) for s in a] \
        == [(s.agent_id, s.arrival_s, s.prompts, s.think_s) for s in b]
    assert a[1].prompts != c[1].prompts

    def sizes(ss):
        return (Counter(len(p) for s in ss for p in s.prompts),
                Counter(len(s.prompts) for s in ss),
                Counter(s.n_new for s in ss),
                sorted(round(t, 9) for s in ss for t in s.think_s),
                sorted(round(t, 9) for t in np.diff(
                    [0.0] + sorted(s.arrival_s for s in ss))))
    assert sizes(a) == sizes(c)


def test_parameters_come_from_the_mix_alone():
    mix = Cell("sc2-agent-fleet").traffic
    base = traffic.sessions(mix, 3, 30.0)
    for key, value in (("max_new_tokens", 40), ("think_s", [1.0, 1.0]),
                       ("turns_per_session", [2, 2])):
        other = traffic.sessions(dict(mix, **{key: value}), 3, 30.0)
        assert [(s.n_new, s.think_s, len(s.prompts)) for s in other] \
            != [(s.n_new, s.think_s, len(s.prompts)) for s in base]


def test_jitter_is_the_backends_draw():
    from repro_torch.serving.backend import _jittered_new_tokens
    mix = Cell("glm3-agent-fleet").traffic
    for s in traffic.sessions(mix, 11, 20.0):
        assert _jittered_new_tokens(mix["max_new_tokens"],
                                    mix["new_tokens_jitter"],
                                    s.agent_id) == s.n_new


def test_shared_prefix_is_block_aligned_and_shared():
    mix = Cell("sc2-agent-fleet").traffic
    conf = Cell("sc2-agent-fleet").config
    ss = traffic.sessions(mix, 4, 20.0)
    p = mix["first_prompt"]["shared_prefix_tokens"]
    assert p % conf["engine"]["block_size"] == 0
    assert len({s.prompts[0][:p] for s in ss}) == 1


def test_tokens_are_the_backends():
    from repro_torch.serving.backend import byte_tokenize
    text = "".join(map(chr, range(1, 128))) * 3
    assert traffic.tokens_of(text, 49152, 300).tolist() == \
        byte_tokenize(text, 49152, 300).tolist()


@pytest.mark.parametrize("cell", [c for c in CELLS if "fleet" in c])
def test_fleet_sessions_fit_max_len(cell):
    c = Cell(cell)
    worst = traffic.worst_session_tokens(c.traffic,
                                         c.traffic["turns_per_session"][1])
    assert worst < c.config["engine"]["max_len"] < \
        c.config["max_position_embeddings"] + 1


@pytest.mark.parametrize("cell", [c for c in CELLS if "decode" in c])
def test_decode_sessions_fit_max_len_over_setup_and_51_s(cell):
    """The longest cache, its first turn, then one token a step: while
    the slowest first turn ends (the jitter's spread), through a 51 s
    window and the 2 s traced sub-window at the fastest step the cell file
    states, and one more turn in flight at the close; and each turn's new
    prompt and the token it carries over."""
    c = Cell(cell)
    mix, s = c.traffic, c.sizing
    gen = mix["max_new_tokens"] + mix["new_tokens_jitter"]
    steps = (mix["new_tokens_jitter"] + (51 + 2) / (s["fastest_step_ms"]
                                                    / 1e3) + gen)
    turns = math.ceil(steps / mix["max_new_tokens"]) + 1
    worst = (mix["first_prompt"]["tokens"][1] + gen + steps
             + turns * (mix["later_prompt"]["max"] + 1))
    assert worst < c.config["engine"]["max_len"]


def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    """Copy the tree, add files and entries only, and the harness finds
    them by name."""
    import shutil
    dest = tmp_path / "tree"
    shutil.copytree(PACKAGE, dest / "agentbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (dest / "agentbench").rglob("*")
              if p.is_file()}
    bench = copy.deepcopy(BENCH)
    mix = load_json(PACKAGE / "traffic" / "agent-fleet.json")
    mix["arrivals"]["sessions_per_s"] = 2.0
    (dest / "agentbench" / "traffic" / "burst.json").write_text(
        json.dumps(mix))
    (dest / "agentbench" / "cells" / "sc2-burst.json").write_text(
        json.dumps({"limits": {"logit_gap": 1.0}}))
    (dest / "agentbench" / "metrics" / "turns_seen.py").write_text(
        "def read(run):\n    return len(run.measured())\n")
    bench["workloads"].append({"name": "sc2-burst", "config": "starcoder2-7b",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "turns_seen", "unit": "turns",
                               "better": "higher", "source": "host_clock",
                               "layer": "AgentRM dispatcher",
                               "moves": "ttft_p95_ms",
                               "workloads": ["sc2-burst"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("sc2-burst", dest)
    assert cell.traffic["arrivals"]["sessions_per_s"] == 2.0
    assert cell.limits == {"logit_gap": 1.0}
    assert [m["name"] for m in cell.metrics(True)] == ["turns_seen"]

    class Run:
        def measured(self):
            return [1, 2, 3]
    assert cell.reader("turns_seen")(Run()) == 3
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_limits(cell):
    c = Cell(cell)
    assert set(c.limits) >= {"turns_lost", "delivery_mismatches",
                             "history_mismatches", "kv_rel_err", "logit_gap"}
    names = [m["name"] for m in c.metrics(False) + c.metrics(True)]
    assert "setup_s" in names and len(c.metrics(True)) >= 1
    for n in names:
        assert (PACKAGE / "metrics" / f"{n}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_a_fixed_schedule_leaves_the_seed_the_contents(cell):
    mix = Cell(cell).traffic
    a, b = traffic.sessions(mix, 3, 30.0), traffic.sessions(mix, 4, 30.0)
    assert [(s.arrival_s, s.n_new, s.think_s, [len(p) for p in s.prompts])
            for s in a] == [(s.arrival_s, s.n_new, s.think_s,
                             [len(p) for p in s.prompts]) for s in b]
    assert a[0].prompts[0] != b[0].prompts[0]


def _horizons(mix):
    """The generator's horizons of an untraced and a traced 51 s run."""
    return [float(mix["preroll_s"]) + 51 + extra for extra in (0.0, 2.0)]


def _session_tokens(s):
    return sum(len(p) + s.n_new + 1 for p in s.prompts)


@pytest.mark.parametrize("cell", [c for c in CELLS if "fleet" in c])
def test_no_fleet_session_reaches_a_sliding_window(cell):
    """Where the configuration has a window, every session of the fixed
    schedule, all turns finished, stays under it: the client never has to
    cap one, and full attention is the window's."""
    c = Cell(cell)
    window = c.config.get("sliding_window") or c.config["engine"]["max_len"]
    for h in _horizons(c.traffic):
        ss = traffic.sessions(c.traffic, 2147483999, h)
        assert max(_session_tokens(s) for s in ss) < window


@pytest.mark.parametrize("cell", CELLS)
def test_the_pool_holds_the_cells_traffic(cell):
    """Sessions keep their pages to the end of a run, so the pool holds
    every page the cell's sessions can fill: each whole (a fleet), or each
    up to max_len (a closed loop that outgrows its turns)."""
    c = Cell(cell)
    e = c.config["engine"]
    blk = e["block_size"]
    for h in _horizons(c.traffic):
        ss = traffic.sessions(c.traffic, 2147483999, h)
        pages = sum(math.ceil(min(_session_tokens(s), e["max_len"]) / blk)
                    for s in ss)
        assert pages < e["num_blocks"] - 1
