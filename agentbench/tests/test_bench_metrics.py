"""The metric arithmetic: tails over every turn and gap, rates over the whole
window, the frozen FLOP and byte counts against hand counts, and the result
line's keys."""
import json
import types

import pytest

from agentbench.kinds import dense
from agentbench.kinds.dense import dims
from agentbench.spec import PACKAGE, Cell
from agentbench.view import RunView, quantile


def turn(due, stamps, delivered="tok:1"):
    return types.SimpleNamespace(
        due=due, delivered=delivered,
        log=types.SimpleNamespace(stamps=stamps, t_begin=due))


def view(turns, start=0.0, end=10.0, steps=()):
    w = types.SimpleNamespace(start=start, end=end, turns=turns)
    return RunView(dims={}, kind=dense, window=w, steps=list(steps),
                   setup_s=1.0, device_name="cpu", max_batch=4,
                   kv_itemsize=2)


def read(metric, run):
    if metric == "gap_p95_ms":         # the stderr line's gap tail
        return 1e3 * quantile(run.gaps_s(), 0.95)
    return Cell("sc2-agent-fleet").reader(metric)(run)


def test_a_stalled_step_moves_the_tails():
    """Forty turns of 20 gaps of 10 ms; one step stalls 0.5 s for every
    turn in flight. A median of chunk medians would not see it; the p95
    over every gap and every turn does."""
    def fleet(stall):
        out = []
        for i in range(40):
            t = [i * 0.2 + 0.05 + 0.01 * k for k in range(20)]
            if stall and i % 10 == 0:
                t = t[:10] + [x + 0.5 for x in t[10:]]
            out.append(turn(i * 0.2, t))
        return view(out)
    calm, stalled = fleet(False), fleet(True)
    assert read("gap_p95_ms", calm) == pytest.approx(10.0)
    # 4 of 780 gaps stall: under 5%, so the gap p95 stays...
    assert read("gap_p95_ms", stalled) == pytest.approx(10.0)
    # ...but the turns that held them are 10% of the turns
    assert read("turn_p95_ms", stalled) > read("turn_p95_ms", calm) + 400
    # one stalled step inside every turn: 1 gap in 19 is over 5%
    more = view([turn(i * 0.2, [i * 0.2 + 0.05 + 0.01 * k + (0.5 if k > 9
                                                              else 0)
                                for k in range(20)]) for i in range(40)])
    assert read("gap_p95_ms", more) == pytest.approx(510.0)
    one = view([turn(0.0, [0.05 + (0.6 if k else 0) for k in range(2)])
                for _ in range(40)])
    assert read("gap_p95_ms", one) == pytest.approx(600.0)


def test_a_failed_turn_misses_every_limit():
    ok = [turn(i * 0.1, [i * 0.1 + 0.02, i * 0.1 + 0.03]) for i in range(19)]
    run = view(ok + [turn(1.0, [], delivered=None)])
    assert read("ttft_p95_ms", run) == pytest.approx(20.0)
    run2 = view(ok + [turn(1.0, [], delivered=None)] * 2)
    assert read("ttft_p95_ms", run2) == float("inf")


def test_only_turns_due_in_the_window_count():
    run = view([turn(-1.0, [5.0]), turn(1.0, [1.1]), turn(10.0, [10.5])],
               start=0.0, end=10.0)
    assert len(run.measured()) == 1
    assert read("ttft_p95_ms", run) == pytest.approx(100.0)


def test_output_tokens_per_s_is_every_token_over_the_whole_window():
    # tokens of turns due before the window count where they land inside
    run = view([turn(-5.0, [-0.5, 0.5, 1.5]), turn(2.0, [3.0, 9.99, 10.0])],
               start=0.0, end=10.0)
    assert Cell("glm3-longctx-decode").reader("output_tokens_per_s")(run) \
        == pytest.approx(4 / 10.0)


def test_quantile_is_nearest_rank():
    xs = list(range(1, 101))
    assert quantile(xs, 0.95) == 95
    assert quantile([3.0], 0.95) == 3.0
    assert quantile([], 0.95) is None


def conf(name):
    return json.loads((PACKAGE / "configs" / f"{name}.json").read_text())


def test_flops_per_token_by_hand():
    """The dense kind's counts, reached through the kind a cell loads."""
    kind = Cell("sc2-agent-fleet").kind
    assert kind.__file__ == str(PACKAGE / "kinds" / "dense.py")
    for name in ("starcoder2-7b", "chatglm3-6b"):
        assert kind.n_params(dims(conf(name))) == conf(name)["params"] == \
            conf(name)["weight_bytes"] // 2
    sc2 = dims(conf("starcoder2-7b"))
    # q 4608x4608, k and v 4608x512 each, o 4608x4608, MLP up and down
    # 4608x18432: 217,055,232 weights a layer, 2 FLOPs each, 32 layers
    assert kind.linear_flops_per_token(sc2) == 2 * 32 * 217_055_232
    glm = dims(conf("chatglm3-6b"))
    # q, o 4096x4096; k, v 4096x256; gate, up, down 4096x13696
    assert kind.linear_flops_per_token(glm) == 2 * 28 * (
        2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696)
    assert kind.unembed_flops(sc2) == 2 * 4608 * 49152
    # one token after 1000 cached: 1001 keys, QK and PV 2*128 FLOPs a key
    # for each of 36 heads, 32 layers
    assert kind.attention_flops(sc2, 1000, 1) == 32 * 36 * 1001 * 4 * 128
    # three tokens from empty: 1 + 2 + 3 keys
    assert kind.attention_flops(sc2, 0, 3) == 32 * 36 * 6 * 4 * 128
    assert kind.step_flops(sc2, [(1000, 1, True), (0, 3, False)]) == (
        4 * kind.linear_flops_per_token(sc2) + kind.unembed_flops(sc2)
        + kind.attention_flops(sc2, 1000, 1)
        + kind.attention_flops(sc2, 0, 3))


def test_k1_bytes_match_the_page_tables():
    """Two rows of a decode step, by hand, and by counting the pages'
    live slots of an engine at smoke size."""
    kind = Cell("glm3-longctx-decode").kind
    glm = dims(conf("chatglm3-6b"))
    per_key = 2 * 2 * 128 * 2          # K and V, 2 KV heads, bf16
    per_row = 2 * 32 * 128 * 2         # q and out, 32 heads, bf16
    assert kind.decode_attention_bytes(glm, [10, 4095]) == 28 * (
        2 * per_row + (11 + 4096) * per_key)
    assert kind.kv_bytes_per_token(glm) == 28 * per_key == \
        conf("chatglm3-6b")["kv_bytes_per_token"]
    assert kind.kv_bytes_per_token(dims(conf("starcoder2-7b"))) == \
        conf("starcoder2-7b")["kv_bytes_per_token"]

    import torch
    from agentbench import stack, weights
    from agentbench.tests.tiny import TINY
    from repro_torch.serving import PagedInferenceEngine
    from repro_torch.weights import prepare_params
    c = dict(conf("chatglm3-6b"), **{k: v for k, v in TINY.items()
                                     if k != "engine"})
    m = dims(c)
    cfg = kind.port_config(c)
    eng = PagedInferenceEngine(cfg, prepare_params(
        weights.draw(m, kind.layer_groups(m), 1, "cpu", torch.bfloat16),
        cfg, "cpu"),
        num_blocks=64, block_size=16, max_batch=4, max_len=256,
        token_budget=32, device="cpu")
    be = stack.TimedBackend(eng, clock=lambda: 0.0)
    for n in (5, 40):
        eng.submit(torch.arange(1, n + 1).numpy(), max_new_tokens=30)
    while any(r.prefilling for r in eng.reqs.values()) or not eng.active:
        be.step()
    live = [r.table.num_tokens for r in eng.active.values()]
    be.step()
    s = be.steps[-1]
    assert s.width == 1
    assert [ctx for ctx, _, _ in s.rows] == live
    slots = sum(r.table.num_tokens for r in eng.active.values())
    assert slots == sum(ctx + 1 for ctx, _, _ in s.rows)
    assert kind.decode_attention_bytes(m, [ctx for ctx, _, _ in s.rows]) \
        == m["L"] * (len(s.rows) * 2 * m["hq"] * m["hd"] * 2
                     + slots * 2 * m["hkv"] * m["hd"] * 2)


def test_the_result_line_carries_only_the_contracts_keys(tmp_path, capsys):
    from agentbench import run
    from agentbench.tests.tiny import make_tree
    root = make_tree(tmp_path / "t")
    assert run.main(["--workload", "tiny-glm3-fleet", "--seed",
                     "2147483999", "--seconds", "1", "--trace", "0"],
                    device="cpu", root=root) == 0
    cap = capsys.readouterr()
    line = cap.out.strip().splitlines()[-1]
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"ttft_p95_ms", "turn_p95_ms",
                                   "itl_p95_ms", "setup_s"}
    assert out["correct"] is True and out["attempted"] > 0
    errs = cap.err.strip().splitlines()
    assert errs[-1].startswith("check ") and "limit" in errs[-1]


def test_no_card_no_result(capsys):
    """The command itself looks for a card; here there is none."""
    import torch
    from agentbench import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sc2-agent-fleet", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_each_steps_device_time_by_kernel():
    """A hand-made trace: two steps, K1's kernels among others, one kernel
    between the steps. Each step keeps every kernel's seconds by name; its
    K1 seconds are what the reading summed before it kept them by name (K1's
    kernels among those whose start lies in the step's span, in order)."""
    from agentbench import trace
    split = "void (anonymous namespace)::paged_split_kernel<bf16>(...)"
    merge = "void (anonymous namespace)::paged_merge_kernel<bf16>(...)"
    tc = "void (anonymous namespace)::paged_tc_kernel<128, 0, 0>(...)"
    gemm = "nvjet_tst_64x16_64x16_4x1_v_bz_NNT"
    ops = [(gemm, 0.125, 0.25), (split, 0.25, 0.375), (merge, 0.375, 0.5),
           (split, 0.5, 0.5625), (merge, 0.5625, 0.625),
           (gemm, 1.0, 1.0625),                       # between the steps
           (gemm, 1.125, 1.375), (tc, 1.375, 1.75), (gemm, 1.75, 1.8125)]
    spans = [(7, 0.0, 0.75), (8, 1.125, 1.9375)]
    got = trace.reduce(ops, spans, 0.0, 2.0)
    assert got.kernel_s == {7: {gemm: 0.125, split: 0.1875, merge: 0.1875},
                            8: {gemm: 0.3125, tc: 0.375}}
    before = {seq: 0.0 for seq, _, _ in spans}
    for name, a, b in ops:
        seq = next((s for s, lo, hi in spans if lo <= a <= hi), None)
        if seq is not None and any(k in name for k in trace.K1_NAMES):
            before[seq] += b - a
    assert got.k1_s == before == {7: 0.375, 8: 0.375}
    assert got.seconds(8, [gemm]) == 0.3125
    assert got.steps == [7, 8]
    assert got.busy_s == 1.25 and got.window_s == 2.0
    assert got.attributed == 1.1875 / 1.25
