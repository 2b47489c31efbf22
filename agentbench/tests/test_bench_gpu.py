"""The harness on the card at smoke sizes: captured steps, the traced
sub-window's reading, and the result line. Marked ``gpu``; each test looks
for the card itself and skips without one. On a card:

    python3 -m pytest -q -m gpu agentbench/tests/test_bench_gpu.py
"""
import json

import pytest
import torch

from agentbench import run
from agentbench.tests.tiny import make_tree

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell,seconds", [("tiny-sc2-decode", "0.5"),
                                          ("tiny-glm3-fleet", "2")])
def test_a_traced_run_on_the_card(card, tmp_path, capsys, cell, seconds):
    # the tiny decode's sessions fill their 2048 positions within seconds
    # on the card: a short window leaves them traffic for the trace
    root = make_tree(tmp_path / "t")
    assert run.main(["--workload", cell, "--seed", "2147483647",
                     "--seconds", seconds, "--trace", "1"], root=root) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]
    diag = json.loads([line for line in cap.err.splitlines()
                       if line.startswith('{"window_s"')][-1])
    # the steps' host spans, mapped onto the trace's clock, hold nearly all
    # of the device's work
    assert diag["trace_attributed"] > 0.9
    # the profiler was warmed in set-up: starting it holds the load back
    # for a moment, not for the seconds CUPTI's first set-up takes
    assert diag["trace_start_pause_ms"] < 500
    assert diag["graph"]["cuda_graphs"] is True
    if cell.endswith("decode"):
        k1 = out["metrics"]["k1_roofline.decode"]["value"]
        assert 0 < k1 <= 100
