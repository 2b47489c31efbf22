"""A configuration names its kind, and everything that reads a model's
shape comes from that kind's files: a kind that only adds files runs a
whole cell; the dense kind draws the weights the harness drew before kinds
existed, bit for bit; a cell lays configuration keys over its
configuration."""
import hashlib
import json

import pytest
import torch

from agentbench import run, stack, weights
from agentbench.kinds import dense
from agentbench.spec import PACKAGE, Cell
from agentbench.tests.tiny import TINY, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def test_a_kind_of_new_files_runs_a_whole_cell(tree, monkeypatch):
    """``two_groups`` is found in the tree's ``kinds/`` by the name its
    configuration gives; no file the tree shares with the benchmark's
    folder differs from it. The run draws its layers as the kind's two
    groups and is correct against the kind's reference."""
    for path in PACKAGE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = tree / "agentbench" / path.relative_to(PACKAGE)
            assert copy.read_bytes() == path.read_bytes(), path
    assert not (PACKAGE / "kinds" / "two_groups.py").exists()
    cell = Cell("tiny-glm3-two-groups-decode", tree)
    assert cell.kind.__file__ == str(tree / "agentbench" / "kinds"
                                     / "two_groups.py")
    drawn = []
    real = weights.draw

    def draw(m, groups, *a, **kw):
        drawn.append([idx for idx, _ in groups])
        return real(m, groups, *a, **kw)
    monkeypatch.setattr(weights, "draw", draw)
    out = run.execute(cell, 2147483999, 1.5, False, torch.device("cpu"))
    assert drawn == [[[0], [1]]]
    checks = run.judge(out["numbers"], cell.limits)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert out["numbers"]["served_tokens_checked"] > 0


# sha256 of ``digest`` over ``weights.draw(dims(conf), 2147483999, "cpu",
# torch.bfloat16)`` at TINY's sizes, as the harness drew before kinds (the
# draw took no groups, ``dims`` came from ``reference.model``), each
# configuration's file updated with TINY's top-level keys; taken by running
# this module's ``digest`` in an unpacked archive of that commit, on the
# torch version that keys it (the CPU's ``randn`` bits differ between
# versions)
BEFORE_KINDS = {"2.13": {
    "starcoder2-7b":
        "359a6c8526c0ea9396ad51a944e0c2b75425767151f4b89c512d898ee04bb06f",
    "chatglm3-6b":
        "88bc7a7891bd731ba98c518c33f3cc8cc34c0ffd79e0508bf693aa5cce4a5f34"}}


def digest(raw) -> str:
    """Every leaf's name, shape and bits, top-level leaves first, then each
    layer's in sorted order."""
    h = hashlib.sha256()

    def add(name, t):
        h.update(f"{name}{tuple(t.shape)}".encode())
        h.update(t.contiguous().view(torch.int16).numpy().tobytes())
    for k in ("embed", "final_norm", "lm_head"):
        add(k, raw[k])
    for li, lay in enumerate(raw["layers"]):
        for k in sorted(lay):
            v = lay[k]
            for n, t in (sorted(v.items()) if isinstance(v, dict)
                         else [("", v)]):
                add(f"{li}.{k}.{n}", t)
    return h.hexdigest()


def draw_before_kinds(m, seed):
    """The draw as it was before kinds: one ``randn`` per dense leaf over
    all L layers, in ``layer_leaves`` order, after the top-level leaves."""
    gen = torch.Generator().manual_seed(seed)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen,
                           dtype=torch.bfloat16).mul_(scale)
    raw = {"embed": rand((m["V"], m["d"]),
                         m["d"] ** -0.5 if m["tied"] else 0.02),
           "final_norm": rand((m["d"],), weights.NORM_SCALE)}
    raw["lm_head"] = (raw["embed"].t() if m["tied"] else
                      rand((m["d"], m["V"]), m["d"] ** -0.5))
    layers = [{"attn": {}, "mlp": {}} for _ in range(m["L"])]
    for name, (shape, scale) in dense.layer_leaves(m).items():
        stacked = rand((m["L"], *shape), scale)
        for li, lay in enumerate(layers):
            *group, leaf = name.split(".")
            (lay[group[0]] if group else lay)[leaf] = stacked[li]
    raw["layers"] = layers
    return raw


@pytest.mark.parametrize("name", ["starcoder2-7b", "chatglm3-6b"])
def test_the_dense_kind_draws_the_same_bits(name):
    """Against the parent's digest where this torch took it, and against
    the draw before kinds on any torch."""
    conf = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    conf.update({k: v for k, v in TINY.items() if k != "engine"})
    m = dense.dims(conf)
    got = digest(weights.draw(m, dense.layer_groups(m), 2147483999, "cpu",
                              torch.bfloat16))
    assert got == digest(draw_before_kinds(m, 2147483999))
    version = ".".join(torch.__version__.split(".")[:2])
    assert got == BEFORE_KINDS.get(version, {}).get(name, got)


def test_a_cell_lays_configuration_keys_over_its_configuration(tree):
    """``"config"`` in a cell's file merges over the configuration file key
    by key, and the engine is built with the cell's pool."""
    folder = tree / "agentbench"
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-sc2-pool", "config": "tiny-sc2",
                               "traffic": "tiny-decode", "chips": 1,
                               "why": "test"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    (folder / "cells" / "tiny-sc2-pool.json").write_text(json.dumps(
        {"config": {"engine": {"num_blocks": 97}}}))
    cell, plain = Cell("tiny-sc2-pool", tree), Cell("tiny-sc2-decode", tree)
    assert cell.config["engine"] == dict(plain.config["engine"],
                                         num_blocks=97)
    assert {k: v for k, v in cell.config.items() if k != "engine"} == \
        {k: v for k, v in plain.config.items() if k != "engine"}
    m = cell.kind.dims(cell.config)
    raw = weights.draw(m, cell.kind.layer_groups(m), 1, "cpu",
                       torch.bfloat16)
    sut = stack.build(cell.config, cell.kind.port_config(cell.config),
                      cell.traffic, raw, "cpu", clock=lambda: 0.0)
    try:
        assert sut.engine.cache.num_blocks == 97
    finally:
        sut.close()
