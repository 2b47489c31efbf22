"""The PyTorch port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``, importing
it pulls in neither, its entry points default to the card, every module
it keeps as a copy equals the reference's once the import prefix is
rewritten, and the copies it has since extended keep the reference's names
but for the ones they dropped."""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

VERBATIM = """configs/base.py configs/gemma_2b.py configs/chatglm3_6b.py
configs/deepseek_67b.py configs/mamba2_370m.py configs/zamba2_7b.py
serving/errors.py serving/backend.py
serving/paging/allocator.py
serving/paging/swap.py serving/autopilot.py
core/__init__.py core/monitor.py
core/scheduler/task.py core/scheduler/drf.py core/scheduler/policies.py
core/scheduler/ratelimit.py core/context/message.py core/context/tiers.py
core/context/psi.py core/context/summarizer.py core/context/baselines.py
core/context/manager.py core/scheduler/scenarios.py core/scheduler/simulator.py
core/scheduler/__init__.py core/context/sessions.py core/context/evaluate.py
core/context/__init__.py serving/journal.py serving/paging/disktier.py
serving/paging/__init__.py serving/__init__.py faults/__init__.py
faults/plan.py faults/inject.py distributed/elastic.py configs/__init__.py
configs/deepseek_v2_lite_16b.py configs/llama4_scout_17b_a16e.py
configs/llava_next_mistral_7b.py configs/starcoder2_7b.py
configs/whisper_tiny.py""".split()

# copies the port has extended (the flight recorder's epoch clock and
# intervals, the dispatcher's pass spans): each keeps every module-level,
# class and method name of the reference's but those listed, which no
# module of the port reads
EXTENDED = {"obs/__init__.py": set(),
            "obs/metrics.py": {"MetricsRegistry.render_text"},
            "obs/trace.py": {"FlightRecorder.span",
                             "FlightRecorder.export_ndjson", "_Span",
                             "_Span.__init__", "_Span.__enter__",
                             "_Span.__exit__", "_MAX_ARGS"},
            "core/middleware.py": set()}


def _port_sources():
    """The package, the scripts run on the card and the tests run there."""
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "megastep_ab.py",
        ROOT / "tests" / "test_torch_kernels_gpu.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


TRAINING_MODULES = """training/__init__.py training/data.py
training/optimizer.py training/train_step.py checkpoint/__init__.py
checkpoint/checkpointer.py launch/train.py tree.py
kernels/flash_attention/backward.py kernels/ssd/backward.py""".split()


def test_training_modules_are_checked():
    """The training path's modules are rewrites, not copies, and each is
    among the sources ``test_no_jax_or_reference_imports`` reads."""
    sources = set(_port_sources())
    for rel in TRAINING_MODULES:
        assert PORT / rel in sources, rel
        assert rel not in VERBATIM
        text = (PORT / rel).read_text()
        assert "import jax" not in text and "from repro." not in text, rel


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            .removesuffix(".__init__") for p in PORT.rglob("*.py")]
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(len(bad)); print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


def _names(path: Path) -> set:
    """Module-level names, classes and ``Class.method`` of a module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef)}
        if isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


@pytest.mark.parametrize("rel", VERBATIM + sorted(EXTENDED))
def test_copied_module_equals_reference(rel):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    got = (PORT / rel).read_text()
    if rel not in EXTENDED:
        assert got == want
        return
    assert "from repro." not in got and "import repro." not in got
    missing = _names(REF / rel) - _names(PORT / rel)
    assert missing == EXTENDED[rel]


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.models.transformer import init_decode_state, init_params
    from repro_torch.serving import InferenceEngine, PagedInferenceEngine
    from repro_torch.serving.paging.pool import PagedKVCache
    from repro_torch.weights import params_from_jax
    cfg = get_smoke_config("gemma-2b")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedInferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedInferenceEngine(cfg, params, megastep=False)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    whisper = get_smoke_config("whisper-tiny")
    with pytest.raises(RuntimeError, match="cuda"):
        encdec.init_params(whisper)
    with pytest.raises(RuntimeError, match="cuda"):
        encdec.init_decode_state(whisper, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVCache(cfg, num_blocks=4, block_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma-2b", "--smoke", "--paged"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"embed": np.zeros((cfg.vocab_size, cfg.d_model),
                                           np.float32)}, cfg)
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticLM
    from repro_torch.weights import train_params_from_jax
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg).init_train_params()
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLM(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        train_params_from_jax({"embed": np.zeros((2, 2), np.float32)})


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Without CUDA (or beside no checkout) it exits non-zero and prints no
    result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
