"""The PyTorch port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``, importing
it pulls in neither, its entry points default to the card, and every module
it keeps as a copy equals the reference's once the import prefix is
rewritten."""
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
configs/deepseek_67b.py serving/errors.py serving/backend.py
serving/paging/allocator.py
serving/paging/swap.py serving/autopilot.py obs/__init__.py obs/metrics.py
obs/trace.py core/__init__.py core/monitor.py core/middleware.py
core/scheduler/task.py core/scheduler/drf.py core/scheduler/policies.py
core/scheduler/ratelimit.py core/context/message.py core/context/tiers.py
core/context/psi.py core/context/summarizer.py core/context/baselines.py
core/context/manager.py""".split()


def _port_sources():
    """The package, chip_smoke.py and the tests run on the card."""
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_gpu.py"]


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


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_equals_reference(rel):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    assert (PORT / rel).read_text() == want


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    from repro_torch.configs import get_smoke_config
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
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVCache(cfg, num_blocks=4, block_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"embed": np.zeros((cfg.vocab_size, cfg.d_model),
                                           np.float32)}, cfg)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Without CUDA (or beside no checkout) it exits non-zero and prints no
    result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
