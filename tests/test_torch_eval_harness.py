"""The paper's evaluation harness in the port against the reference's.

The port's copies of ``core/scheduler/{scenarios,simulator}.py`` and
``core/context/{sessions,evaluate}.py`` are deterministic, so the same
scenario and seed give equal results from both packages: the MLFQ table
(``run_policy`` over every scenario, FIFO and MLFQ) and the CLM table
(``evaluate`` over every session and context strategy)."""
import dataclasses

import pytest

from repro.core import context as ref_ctx
from repro.core import scheduler as ref_sched
from repro_torch.core import context as ctx
from repro_torch.core import scheduler as sched


@pytest.mark.parametrize("policy", ["fifo", "mlfq"])
@pytest.mark.parametrize("scenario", list(ref_sched.SCENARIOS))
def test_scheduler_table_equals_reference(scenario, policy):
    assert list(sched.SCENARIOS) == list(ref_sched.SCENARIOS)
    scn, ref_scn = sched.SCENARIOS[scenario], ref_sched.SCENARIOS[scenario]
    got = sched.run_policy(policy, sched.make_turns(scn, seed=0),
                           lanes=scn.lanes)
    want = ref_sched.run_policy(policy, ref_sched.make_turns(ref_scn, seed=0),
                                lanes=ref_scn.lanes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_scheduler_seeded_runs_equal_reference():
    """A non-default seed reaches the simulator's RNG the same way."""
    scn = sched.SCENARIOS["faulty"]
    got = sched.run_policy("mlfq", sched.make_turns(scn, seed=7), lanes=3,
                           seed=7)
    want = ref_sched.run_policy(
        "mlfq", ref_sched.make_turns(ref_sched.SCENARIOS["faulty"], seed=7),
        lanes=3, seed=7)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("strategy", list(ref_ctx.STRATEGIES))
@pytest.mark.parametrize("session", list(ref_ctx.SESSIONS))
def test_context_table_equals_reference(session, strategy):
    assert list(ctx.SESSIONS) == list(ref_ctx.SESSIONS)
    assert list(ctx.STRATEGIES) == list(ref_ctx.STRATEGIES)

    def table(mod):
        st = mod.STRATEGIES[strategy]()
        mod.run_session(st, mod.make_session(mod.SESSIONS[session], seed=0))
        return mod.evaluate(st, mod.make_session(mod.SESSIONS[session],
                                                 seed=0))

    got, want = table(ctx), table(ref_ctx)
    assert got == want
    assert set(got) >= {"retention", "quality", "compact_cost"}
