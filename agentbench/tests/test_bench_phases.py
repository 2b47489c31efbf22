"""The flight-recorder readers of ``agentbench.phases``: on synthetic kernel
intervals and recorder events (the idle split and its identity, the
innermost span, per-turn wait sums, the first-token join, the counter over
the window, nothing read where the recorder dropped events), then through a
run of a tiny cell on the CPU, and (marked ``gpu``) a traced run on the
card."""
import json
import math
import subprocess
import sys

import pytest
import torch

from agentbench import phases
from agentbench.spec import ROOT
from agentbench.tests.test_bench_isolation import loaded_after
from agentbench.tests.tiny import make_tree

from repro_torch.obs import FlightRecorder, TraceConfig
from repro_torch.serving.paging.engine import PHASES


def ev(name, ts, dur=0.0, **args):
    return {"name": name, "ph": "X" if dur else "i", "ts": ts, "dur": dur,
            "args": {k: float(v) for k, v in args.items()}}


def test_the_idle_split_adds_up_to_the_idle_share():
    busy = [(1.0, 2.0), (3.0, 3.5), (4.0, 6.0)]
    spans = [(0.5, 1.5, "pack"), (1.5, 2.5, "launch"),
             (2.5, 3.8, "readback"), (5.0, 7.0, "charge")]
    split = phases.idle_split(busy, 0.0, 8.0, spans)
    # idle: [0, 1), [2, 3), [3.5, 4), [6, 8)
    assert split["pack"] == pytest.approx(0.5)
    assert split["launch"] == pytest.approx(0.5)
    assert split["readback"] == pytest.approx(0.5 + 0.3)
    assert split["charge"] == pytest.approx(1.0)
    assert split["uncovered"] == pytest.approx(0.5 + 0.2 + 1.0)
    pct = phases.shares(split, 8.0)
    assert pct["idle"] == pytest.approx(100.0 * (8.0 - 3.5) / 8.0)
    assert pct["host"] == pytest.approx(100.0 * 2.0 / 8.0)
    assert pct["replay"] == pytest.approx(100.0 * 0.8 / 8.0)
    assert pct["wait"] == 0.0


def test_idle_intervals_are_clipped_to_the_window():
    assert phases.idle_intervals([(0.5, 1.0), (2.0, 9.0)], 0.0, 4.0) == [
        (0.0, 0.5), (1.0, 2.0)]
    assert phases.idle_intervals([], 1.0, 2.0) == [(1.0, 2.0)]


def test_the_innermost_span_takes_the_time():
    segs = phases.timeline([(0.0, 10.0, "outer"), (2.0, 4.0, "inner"),
                            (3.0, 3.5, "core"), (6.0, 7.0, "inner")])
    assert segs == [(0.0, 2.0, "outer"), (2.0, 3.0, "inner"),
                    (3.0, 3.5, "core"), (3.5, 4.0, "inner"),
                    (4.0, 6.0, "outer"), (6.0, 7.0, "inner"),
                    (7.0, 10.0, "outer")]
    split = phases.idle_split([], 0.0, 12.0, [(0.0, 10.0, "pass"),
                                              (2.0, 4.0, "wait")])
    assert (split["pass"], split["wait"], split["uncovered"]) == (
        pytest.approx(8.0), pytest.approx(2.0), pytest.approx(2.0))


EVENTS = [
    ev("sched.submitted", 0.5, tid=9),                 # before the window
    ev("sched.submitted", 1.0, tid=1),
    ev("sched.submitted", 1.5, tid=2),
    ev("sched.submitted", 2.0, tid=3),
    ev("sched.admitted", 0.6, tid=9, wait_s=0.1),
    ev("session.enqueued", 1.1, rid=4),
    ev("sched.admitted", 1.2, tid=1, wait_s=0.2),
    ev("sched.started", 1.2, tid=1, rid=4, resumed=0),
    ev("session.enqueued", 1.6, rid=5),
    ev("sched.admitted", 1.7, tid=2, wait_s=0.2),
    ev("sched.started", 1.7, tid=2, rid=5, resumed=0),
    ev("session.token", 1.9, rid=4, n_out=1),
    ev("session.token", 2.0, rid=4, n_out=2),
    ev("sched.preempted", 2.1, tid=1),
    ev("sched.admitted", 2.6, tid=1, wait_s=0.5),
    ev("sched.started", 2.6, tid=1, rid=4, resumed=1),
    ev("session.token", 2.7, rid=5, n_out=1),
]


def test_each_turns_waits_summed_over_its_admissions():
    waits = phases.mlfq_queued_s(EVENTS, 1.0, 3.0)
    # tid 1 waited twice, tid 2 once, tid 3 was never admitted
    assert waits == [pytest.approx(0.7), pytest.approx(0.2), math.inf]
    assert phases.p95_ms([0.1, 0.2]) == pytest.approx(200.0)
    assert phases.p95_ms(waits) is None


def test_the_first_token_joins_through_the_turns_session():
    ttft = phases.engine_ttft_s(EVENTS, 1.0, 3.0)
    assert ttft == [pytest.approx(0.8), pytest.approx(1.1), math.inf]
    # a later turn of the same session starts its own clock
    later = EVENTS + [ev("sched.submitted", 2.9, tid=7),
                      ev("session.enqueued", 3.0, rid=4),
                      ev("sched.started", 3.1, tid=7, rid=4, resumed=0),
                      ev("session.token", 3.4, rid=4, n_out=1)]
    assert phases.engine_ttft_s(later, 2.8, 3.0) == [pytest.approx(0.4)]


def test_the_counter_over_the_window_a_turn():
    assert phases.preemptions_per_turn({"rm.preemptions": 3.0},
                                       {"rm.preemptions": 9.0}, 4) == 1.5
    assert phases.preemptions_per_turn({"rm.preemptions": 0.0},
                                       {"rm.preemptions": 0.0}, 0) is None


def _step(seq, t0, C, durs):
    out = [ev("engine.admit", t0 - durs[0], durs[0], seq=seq, C=C, rows=2)]
    t = t0
    for name, d in zip(phases.ENGINE[1:], durs[1:]):
        out.append(ev(f"engine.{name}", t, d, seq=seq, C=C, rows=2))
        t += d
    out.append(ev("engine.megastep", t0, t - t0, seq=seq, C=C, rows=2,
                  tokens_real=2))
    return out


def test_host_phases_by_step_kind():
    assert phases.ENGINE == PHASES          # the program's span names
    events = (_step(1, 1.0, 1, [1e-3, 2e-3, 1e-3, 1e-3, 10e-3, 1e-3])
              + _step(2, 2.0, 64, [3e-3, 2e-3, 1e-3, 1e-3, 50e-3, 3e-3])
              + _step(3, 9.0, 1, [1e-3] * 6))          # after the window
    steps = phases.window_steps(events, 0.5, 5.0)
    assert sorted(steps) == [1, 2]
    table = phases.step_phases(steps)
    assert table["decode"]["host"][0] == pytest.approx(6.0)
    assert table["decode"]["readback"][0] == pytest.approx(10.0)
    assert table["mixed"]["host"][0] == pytest.approx(10.0)
    assert phases.step_host_ms(steps) == pytest.approx(8.0)
    assert phases.step_host_ms({}) is None


def test_nothing_is_read_where_the_recorder_dropped_events():
    rec = FlightRecorder(TraceConfig(enabled=True, capacity=16))
    for i in range(20):
        rec.instant(rec.name("tick"), 0, i)

    class Engine:
        class obs:
            recorder = rec
    out = phases.report({"engine": Engine, "out": {"view": None},
                         "window": (0.0, 1.0)})
    assert out["dropped"] == 4
    assert "dropped 4 events" in out["why_none"]
    assert "step_host_ms" not in out and "idle_s" not in out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def _phases_line(err: str) -> dict:
    return json.loads([line for line in err.splitlines()
                       if line.startswith('{"phases":')][-1])["phases"]


def test_a_run_with_the_recorder_on(tree, capsys):
    rc = phases.main(["--workload", "tiny-sc2-fleet", "--seed", "2147483999",
                      "--seconds", "1.5", "--trace", "0"], device="cpu",
                     root=tree)
    assert rc == 0
    cap = capsys.readouterr()
    result = json.loads(cap.out.strip().splitlines()[-1])
    assert result["correct"] is True
    got = _phases_line(cap.err)
    assert got["dropped"] == 0 and got["window_turns"] > 0
    assert got["step_host_ms"] > 0
    assert got["mlfq_queued_p95_ms"] >= 0
    assert got["engine_ttft_p95_ms"] > 0
    assert got["preemptions_per_turn"] >= 0
    assert set(got["step_phases_ms"]) <= {"decode", "mixed"}
    # the wrappers are taken off again
    from agentbench import client, run, stack, trace
    assert run.execute.__module__ == "agentbench.run"
    assert client.drive.__module__ == "agentbench.client"
    assert trace.read.__module__ == "agentbench.trace"
    assert stack.PagedInferenceEngine.__name__ == "PagedInferenceEngine"


def test_the_command_finds_the_program_by_itself():
    # no ``src`` on the path: the command puts the checkout's there, as
    # ``agentbench.run`` does, before it builds the recorder
    out = subprocess.run(
        [sys.executable, "-m", "agentbench.phases", "--workload", "none",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1
    assert "no workload 'none'" in out.stderr, out.stderr[-2000:]


def test_the_phases_reader_loads_no_jax():
    names = loaded_after("import agentbench.phases")
    assert not names & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.gpu
def test_a_traced_run_on_the_card_splits_the_whole_idle(tree, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert phases.main(["--workload", "tiny-sc2-decode", "--seed",
                        "2147483647", "--seconds", "0.5", "--trace", "1"],
                       root=tree) == 0
    got = _phases_line(capsys.readouterr().err)
    assert got["dropped"] == 0
    assert got["identity_pp"] < 0.5
    assert got["shares_pct"]["idle"] == pytest.approx(
        got["device_idle_pct"], abs=0.5)
    assert got["step_wall_ms"]["sub_window"] > 0
