"""What the harness loads: never JAX nor the JAX package (top-level names
compared whole, so the program ``repro_torch`` is allowed), and in the
reference not the program either."""
import ast
import subprocess
import sys

from agentbench import run
from agentbench.spec import PACKAGE, ROOT

HARNESS = ["agentbench.run", "agentbench.check", "agentbench.client",
           "agentbench.flops", "agentbench.spec", "agentbench.stack",
           "agentbench.trace", "agentbench.traffic", "agentbench.view",
           "agentbench.weights", "agentbench.reference.model"]


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    readers = "\n".join(
        f"Cell('sc2-agent-fleet').reader({p.stem!r})"
        for p in sorted((PACKAGE / "metrics").glob("*.py")))
    names = loaded_after("\n".join(f"import {m}" for m in HARNESS)
                         + "\nfrom agentbench.spec import Cell\n" + readers)
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
