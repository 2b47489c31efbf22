"""What the harness loads: never JAX nor the JAX package (top-level names
compared whole, so the program ``repro_torch`` is allowed), and in the
reference not the program either."""
import ast
import json
import subprocess
import sys

from agentbench import run
from agentbench.spec import PACKAGE, ROOT
from agentbench.tests.tiny import LIMITS, make_tree

HARNESS = ["agentbench.run", "agentbench.check", "agentbench.client",
           "agentbench.flops", "agentbench.spec", "agentbench.stack",
           "agentbench.trace", "agentbench.traffic", "agentbench.view",
           "agentbench.weights", "agentbench.reference.model",
           "agentbench.kinds.dense"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    """The harness's modules, every reader, and every kind with the
    reference it names, each loaded by path as a run loads it."""
    readers = "\n".join(
        f"Cell('sc2-agent-fleet').reader({p.stem!r})"
        for p in sorted((PACKAGE / "metrics").glob("*.py")))
    kinds = "\n".join(
        f"k = Cell('sc2-agent-fleet')._load('kinds', {p.stem!r})\n"
        f"Cell('sc2-agent-fleet')._load('reference', k.REFERENCE)"
        for p in sorted((PACKAGE / "kinds").glob("*.py"))
        if p.stem != "__init__")
    assert "dense" in kinds
    names = loaded_after("\n".join(f"import {m}" for m in HARNESS)
                         + "\nfrom agentbench.spec import Cell\n" + readers
                         + "\n" + kinds)
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_neither_jax_nor_the_program():
    names = loaded_after("import agentbench.reference.model")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    for path in (PACKAGE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in {"torch", "math", "typing",
                                             "__future__"}, (path, mod)


def test_the_look_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro", "jaxlib"} <= set(run.forbidden_modules())


def test_a_reference_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                                    capsys):
    """A kind whose reference imports ``jax`` (a stub here) is first loaded
    by the check, after the window: the run still names it, prints no
    result and exits 3."""
    tree = make_tree(tmp_path / "tree")
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text('"""A stand-in for JAX."""\n')
    monkeypatch.syspath_prepend(str(stub))
    folder = tree / "agentbench"
    (folder / "kinds" / "loads_jax.py").write_text(
        "from agentbench.kinds.dense import (  # noqa: F401\n"
        "    decode_attention_bytes, dims, kv_bytes_per_token, layer_groups,\n"
        "    max_context, n_params, port_config, step_flops)\n"
        "REFERENCE = 'loads_jax'\n")
    (folder / "reference" / "loads_jax.py").write_text(
        "import jax  # noqa: F401\n"
        "from agentbench.reference.model import (  # noqa: F401\n"
        "    exact_float32, run)\n")
    conf = json.loads((folder / "configs" / "tiny-glm3.json").read_text())
    conf.update(name="tiny-glm3-jax", kind="loads_jax")
    (folder / "configs" / "tiny-glm3-jax.json").write_text(json.dumps(conf))
    (folder / "cells" / "tiny-glm3-jax-decode.json").write_text(json.dumps(
        {"check": {"sessions": 2, "served_tokens": 20}, "limits": LIMITS}))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-glm3-jax", "source": "test",
                             "file": "agentbench/configs/tiny-glm3-jax.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-glm3-jax-decode",
                               "config": "tiny-glm3-jax",
                               "traffic": "tiny-decode", "chips": 1,
                               "why": "test"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "jax" not in sys.modules
    try:
        rc = run.main(["--workload", "tiny-glm3-jax-decode", "--seed",
                       "2147483999", "--seconds", "1.5", "--trace", "0"],
                      device="cpu", root=tree)
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    cap = capsys.readouterr()
    assert rc == 3 and cap.out == ""
    assert "['jax']" in cap.err.strip().splitlines()[-1]
