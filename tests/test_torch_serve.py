"""The port's serving CLI, ``repro_torch.launch.serve``, against the
reference's ``repro.launch.serve``.

Every flag-validation ``SystemExit`` of ``main``, ``build_backend`` and
``build_mesh`` carries the reference's message; ``main`` runs end to end on
the CPU (``--smoke --device cpu``) with a journal, a disk tier, tracing
and a metrics dump, with a fleet and a kill or a drain, with the
autopilot, and on the dense engine; both CLIs' ``build_backend`` under
their AgentRM give equal outputs for the same converted weights at
float32; and ``--mesh tp=1`` serves as the run without a mesh, while a
mesh wider than the host's devices exits with the reference's message."""
import argparse
import json
import re

import jax
import numpy as np
import pytest
import torch

import repro.core
from repro.configs import get_smoke_config as jax_smoke
from repro.core.scheduler.task import QueueClass as RefQueueClass
from repro.launch import serve as ref_serve
from repro.models import build
import repro_torch.core
from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.task import QueueClass
from repro_torch.launch import serve
from repro_torch.obs import validate_chrome
from repro_torch.weights import params_from_jax

BASE = ["--arch", "gemma-2b", "--smoke"]
PORT = ["--device", "cpu"]

BAD_ARGV = [
    ["--turn-timeout", "0"],
    ["--step-deadline", "-1"],
    ["--journal-dir", "J"],
    ["--fleet", "0"],
    ["--fleet", "2"],
    ["--spill-dir", "S"],
    ["--paged", "--spill-capacity-mb", "0"],
    ["--paged", "--kill", "0"],
    ["--paged", "--fleet", "2", "--kill", "2"],
    ["--paged", "--fleet", "2", "--drain", "-1"],
    ["--paged", "--fleet", "3", "--kill", "1", "--drain", "1"],
    ["--autopilot"],
    ["--paged", "--autopilot", "--slo-ttft-p95", "0"],
    ["--paged", "--autopilot", "--slo-itl-p95", "-1"],
    ["--trace-capacity", "8"],
    ["--trace-out", "T", "--trace-capacity", "99999999"],
    # build_backend, after the weights are drawn
    ["--token-budget", "8"],
    ["--mesh", "tp=2"],
    ["--paged", "--token-budget", "2"],
    ["--paged", "--fleet", "2", "--token-budget", "2"],
    # build_mesh
    ["--paged", "--mesh", "dp=2"],
    ["--paged", "--mesh", "tp=two"],
    ["--paged", "--mesh", "tp=2"],
    ["--paged", "--mesh", "tp=0"],
]


@pytest.mark.parametrize("argv", BAD_ARGV, ids=" ".join)
def test_cli_errors_equal_reference(argv):
    with pytest.raises(SystemExit) as want:
        ref_serve.main(BASE + argv)
    with pytest.raises(SystemExit) as got:
        serve.main(BASE + PORT + argv)
    assert isinstance(want.value.code, str) and want.value.code
    assert got.value.code == want.value.code


def test_mesh_spec_and_build_mesh_errors_equal_reference():
    """``test_sharded_megastep.py::test_serve_cli_mesh_errors_are_systemexit``
    on both CLIs."""
    assert serve.parse_mesh_spec("tp=4") == ref_serve.parse_mesh_spec(
        "tp=4") == 4
    for spec in ("dp=2", "tp=two", "tp", "=2"):
        with pytest.raises(ValueError) as want:
            ref_serve.parse_mesh_spec(spec)
        with pytest.raises(ValueError) as got:
            serve.parse_mesh_spec(spec)
        assert str(got.value) == str(want.value)
    cfg = get_smoke_config("gemma-2b")
    jcfg = jax_smoke("gemma-2b")
    for ns in (argparse.Namespace(mesh="tp=2", paged=False),
               argparse.Namespace(mesh="dp=2", paged=True),
               argparse.Namespace(mesh="tp=2", paged=True)):
        with pytest.raises(SystemExit) as want:
            ref_serve.build_mesh(jcfg, ns)
        with pytest.raises(SystemExit) as got:
            serve.build_mesh(cfg, ns)
        assert got.value.code == want.value.code
    assert serve.build_mesh(cfg, argparse.Namespace(mesh=None,
                                                    paged=True)) is None
    assert serve.build_mesh(cfg, argparse.Namespace(paged=True)) is None


def test_valid_mesh_exits_as_not_ported(capsys):
    """Named for what the port once did: a valid ``--mesh`` now serves.
    ``--mesh tp=1`` on the CPU (one device) gives the mesh-less run's
    turns, token for token; ``tp=2`` there exits with the reference's
    message up to its hint (the reference's names XLA's forced host
    devices, the port's ``make_tp_mesh(devices=...)``)."""
    argv = BASE + PORT + ["--paged", "--agents", "2", "--turns", "4"]
    assert serve.main(argv) == 0
    plain = _served_lines(capsys.readouterr().out)
    assert serve.main(argv + ["--mesh", "tp=1"]) == 0
    out = capsys.readouterr().out
    assert len(plain) == 4 and _served_lines(out) == plain
    assert "tp=1," in out
    sc2 = ["--arch", "starcoder2-7b", "--smoke", "--paged", "--mesh", "tp=2"]
    with pytest.raises(SystemExit) as want:
        ref_serve.main(sc2)
    with pytest.raises(SystemExit) as got:
        serve.main(sc2 + PORT)
    assert want.value.code.startswith(
        "invalid --mesh: tp=2 exceeds the 1 visible device(s);")
    assert got.value.code.split(";")[0] == want.value.code.split(";")[0]
    mesh = serve.build_mesh(get_smoke_config("gemma-2b"), argparse.Namespace(
        mesh="tp=1", paged=True, device="cpu"))
    assert mesh.shape == {"tp": 1} and mesh.devices == (torch.device("cpu"),)


# ------------------------------------------------------ end-to-end runs

def _served(out: str) -> list:
    return re.findall(r"^\[serve\] agent-\d+ -> tok:", out, re.M)


def _served_lines(out: str) -> list:
    """Each served turn's agent and tokens (its latency cut), sorted."""
    return sorted(re.findall(r"^(\[serve\] agent-\d+ -> tok:\S*)", out,
                             re.M))


def _dispatches(out: str):
    m = re.search(r"jit dispatches (\d+) over (\d+) steps", out)
    return int(m.group(1)), int(m.group(2))


def test_main_paged_with_journal_spill_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    rc = serve.main(BASE + PORT + [
        "--paged", "--token-budget", "64", "--agents", "3", "--turns", "9",
        "--journal-dir", str(tmp_path / "j"),
        "--spill-dir", str(tmp_path / "s"),
        "--trace-out", str(trace), "--metrics-dump", str(metrics)])
    out = capsys.readouterr().out
    assert rc == 0
    assert len(_served(out)) == 9
    disp, steps = _dispatches(out)
    assert disp == steps > 0
    assert "megastep: 1.00 dispatches/step" in out
    assert validate_chrome(json.loads(trace.read_text())) == []
    snap = json.loads(metrics.read_text())
    assert snap
    assert any(p.name.endswith(".npz") for p in (tmp_path / "j").iterdir())


@pytest.mark.parametrize("fleet", [2, 3])
def test_main_fleet_kill_every_turn_completes(fleet, tmp_path, capsys):
    rc = serve.main(BASE + PORT + [
        "--paged", "--fleet", str(fleet), "--agents", "4", "--turns", "12",
        "--journal-dir", str(tmp_path / "j"), "--kill", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    lost = out.count("ENGINE LOST mid-turn")
    assert len(_served(out)) == 12
    assert "TIMED OUT" not in out and "giving up" not in out
    assert "=== killed engine0" in out
    assert re.search(r"fleet: \d+ active \| lost 1 drained 0", out)
    if lost:
        assert f"turns resubmitted {lost}" in out
    disp, steps = _dispatches(out)
    assert disp == steps > 0


def test_main_fleet_drain_fails_no_turn(capsys):
    rc = serve.main(BASE + PORT + ["--paged", "--fleet", "2", "--drain",
                                   "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert len(_served(out)) == 9
    assert "ENGINE LOST" not in out and "TIMED OUT" not in out
    assert re.search(r"lost 0 drained 1", out)
    assert "engine1: drained, 0 sessions" in out


def test_main_autopilot(capsys):
    rc = serve.main(BASE + PORT + ["--paged", "--autopilot"])
    out = capsys.readouterr().out
    assert rc == 0
    assert len(_served(out)) == 9
    assert re.search(r"^\[serve\] autopilot: rung \d", out, re.M)


def test_main_dense_engine(capsys):
    rc = serve.main(BASE + PORT)
    out = capsys.readouterr().out
    assert rc == 0
    assert len(_served(out)) == 9
    assert "megastep:" not in out


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "starcoder2-7b",
                                  "llava-next-mistral-7b"])
def test_main_paged_serves_every_gqa_family(arch, capsys):
    """MoE, a plain GELU MLP at g = 2, and the VLM's text path through the
    megastep."""
    rc = serve.main(["--arch", arch, "--smoke", "--paged"] + PORT)
    out = capsys.readouterr().out
    assert rc == 0
    assert len(_served(out)) == 9
    disp, steps = _dispatches(out)
    assert disp == steps > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("arch,why", [("deepseek-v2-lite-16b", "MLA"),
                                      ("whisper-tiny", "encoder-decoder")])
def test_main_refuses_mla_and_encoder_decoder(arch, why, paged):
    """Neither engine serves these families, as in the reference (its
    engines assert the family, or fail at MLA's first decode step)."""
    with pytest.raises(NotImplementedError, match=why):
        serve.main(["--arch", arch, "--smoke"] + PORT
                   + (["--paged"] if paged else []))


# -------------------------------------- build_backend against the reference

def _args(paged: bool, device=None) -> argparse.Namespace:
    """One batch row for the paged engine, and a slot per agent for the
    dense one (so no agent's session is evicted for another's): every
    turn's output then depends on its own agent's turns alone, whichever
    order the dispatcher serves the agents in."""
    ns = argparse.Namespace(
        paged=paged, token_budget=16 if paged else 0, mesh=None, lanes=3,
        max_len=192, max_new_tokens=8, num_blocks=129, block_size=8,
        max_batch=1, prefill_chunk=16, journal_dir=None, fleet=1,
        spill_dir=None, spill_capacity_mb=64)
    if device is not None:
        ns.device = device
    return ns


def _nine_turns(core, queue_class, backend) -> list:
    """The CLI's nine turns of three agents through ``core.AgentRM``, each
    submitted once the one before has returned, so both packages serve
    them in the CLI's order."""
    rm = core.AgentRM(backend, core.AgentRMConfig(lanes=1,
                                                  detect_after_s=20.0))
    try:
        return [rm.submit(f"agent-{i % 3}", f"turn {i}: do the thing",
                          queue_class=(queue_class.INTERACTIVE,
                                       queue_class.SUBAGENT,
                                       queue_class.BACKGROUND)[i % 3]
                          ).result(timeout=120)
                for i in range(9)]
    finally:
        rm.shutdown()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_build_backend_gives_reference_outputs(paged):
    jcfg = jax_smoke("gemma-2b").replace(remat=False,
                                         compute_dtype="float32")
    cfg = get_smoke_config("gemma-2b").replace(remat=False,
                                               compute_dtype="float32")
    jparams = build(jcfg).init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    _, want_be = ref_serve.build_backend(jcfg, jparams, _args(paged))
    _, got_be = serve.build_backend(cfg, params, _args(paged, "cpu"))
    want = _nine_turns(repro.core, RefQueueClass, want_be)
    got = _nine_turns(repro_torch.core, QueueClass, got_be)
    assert all(s.startswith("tok:") for s in got)
    assert got == want
