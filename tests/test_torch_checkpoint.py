"""The port's checkpoint and restart (``repro_torch.checkpoint``,
``launch.train``, ``distributed.sharding.elastic_restore``), mirroring
tests/test_fault_tolerance.py on the port, on the CPU: bitwise resume,
atomic publish over a partial write, ``keep_last``, gradient compression
converging like the uncompressed run, the CLI's ``--fail-at`` then
``--resume``, the straggler detector. Across the packages: a checkpoint
the reference's ``Checkpointer`` writes restores in the port's and the
reverse, leaf for leaf; the counterpart of
test_model_consistency.py::test_elastic_remesh_checkpoint restores a
reference checkpoint onto the port's device.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build as ref_build
from repro.training import optimizer as ref_opt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (Placement, elastic_restore,
                                              join, reshard_params)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_step import make_train_step
from repro_torch.tree import leaves, tree_map
from repro_torch.weights import forward_params, train_params_from_jax

ARCH = "gemma-2b"


def _setup(compress=False):
    cfg = get_smoke_config(ARCH).replace(remat=False)
    ocfg = opt.AdamWConfig(lr=1e-3, compress_grads=compress)
    step_fn = make_train_step(cfg, ocfg)
    params = build(cfg).init_train_params(seed=0, device="cpu")
    state = opt.init(params, ocfg)
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    return step_fn, params, state, data


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _assert_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume_is_bitwise_identical(tmp_path):
    step_fn, params, state, data = _setup()
    ck = Checkpointer(str(tmp_path))
    # continuous run: 5 steps (the update runs in place: work on copies)
    p, s = _clone(params), _clone(state)
    for i in range(5):
        p, s, _ = step_fn(p, s, data.batch_at(i))
    # interrupted run: 3 steps, checkpoint, "crash", restore, 2 more
    p2, s2 = _clone(params), _clone(state)
    for i in range(3):
        p2, s2, _ = step_fn(p2, s2, data.batch_at(i))
    ck.save(3, (p2, s2))
    del p2, s2                                     # crash
    (p3, s3), start, _ = ck.restore((params, state))
    assert start == 3
    for i in range(3, 5):
        p3, s3, _ = step_fn(p3, s3, data.batch_at(i))
    _assert_equal(p, p3)
    _assert_equal(s, s3)


def test_atomic_publish_survives_partial_write(tmp_path):
    _, params, state, _ = _setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, (params, state))
    # a crashed (partial) write of step 2: a .tmp dir left behind
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("x")
    assert ck.latest_step() == 1                   # tmp is invisible
    (_, __), step, ___ = ck.restore((params, state))
    assert step == 1
    ck.save(2, (params, state))                    # the next save replaces it
    assert ck.all_steps() == [1, 2]
    assert not os.path.exists(tmp_path / "step_00000002.tmp")


def test_keep_last_prunes(tmp_path):
    _, params, state, _ = _setup()
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(s, (params, state))
    assert ck.all_steps() == [3, 4]


def test_restore_refuses_another_structure(tmp_path):
    _, params, state, _ = _setup()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params)
    with pytest.raises(ValueError, match="leaf count"):
        ck.restore((params, state))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(params)


def test_gradient_compression_trains_and_converges_similarly():
    step_fn, params, state, data = _setup(compress=False)
    step_c, params_c, state_c, data_c = _setup(compress=True)
    assert state_c.err is not None and state.err is None
    p, s, pc, sc = params, state, params_c, state_c
    for i in range(8):
        p, s, m = step_fn(p, s, data.batch_at(i))
        pc, sc, mc = step_c(pc, sc, data_c.batch_at(i))
        l0, lc = float(m["loss"]), float(mc["loss"])
    assert np.isfinite(lc)
    assert abs(l0 - lc) / l0 < 0.05, \
        f"bf16+error-feedback diverged: {l0} vs {lc}"


def _cli(argv):
    from repro_torch.launch.train import main
    return main(argv + ["--device", "cpu"])


def test_train_cli_fail_and_resume(tmp_path):
    """End-to-end: the launcher crashes at --fail-at, then --resume
    continues to completion, ending on the same bits as a run that never
    failed."""
    args = ["--arch", "mamba2-370m", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "16", "--save-every", "2"]
    ckpt = str(tmp_path / "ck")
    assert _cli(args + ["--ckpt-dir", ckpt, "--fail-at", "3"]) == 42
    assert Checkpointer(ckpt).all_steps() == [2, 4]
    assert _cli(args + ["--ckpt-dir", ckpt, "--resume"]) == 0
    straight = str(tmp_path / "straight")
    assert _cli(args + ["--ckpt-dir", straight]) == 0
    a = np.load(os.path.join(ckpt, "step_00000006", "proc0.npz"))
    b = np.load(os.path.join(straight, "step_00000006", "proc0.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_on_step_and_compression(capsys):
    seen = []
    from repro_torch.launch.train import main
    rc = main(["--arch", "gemma-2b", "--smoke", "--steps", "2", "--batch",
               "2", "--seq", "16", "--compress-grads", "--device", "cpu"],
              on_step=seen.append)
    assert rc == 0
    assert [m["step"] for m in seen] == [0, 1]
    assert set(seen[0]) == {"step", "loss", "ce", "moe_aux", "moe_z",
                            "grad_norm", "seconds"}
    assert "[train] done: 2 steps" in capsys.readouterr().out


def test_straggler_detector():
    from repro_torch.core.monitor import ResourceMonitor
    mon = ResourceMonitor(straggler_factor=3.0)
    for _ in range(10):
        mon.observe_step(1.0)
    assert mon.observe_step(10.0) is True
    assert mon.stragglers == 1
    assert mon.observe_step(1.0) is False


# --------------------------------------------------- across the packages

def _ref_tree(compress):
    cfg = ref_smoke(ARCH).replace(remat=False)
    params = ref_build(cfg).init_params(jax.random.PRNGKey(0))
    ocfg = ref_opt.AdamWConfig(compress_grads=compress)
    state = ref_opt.init(params, ocfg)
    # moments that are not zeros, so the order of the leaves shows
    rng = np.random.default_rng(1)
    state = state._replace(
        step=state.step + 7,
        m=jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), state.m),
        v=jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                       state.v))
    return params, state


def _port_like(params, state):
    """The port's (master, AdamWState) of the same structure, zeros."""
    master = train_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    zero = tree_map(torch.zeros_like, master)
    return zero, opt.AdamWState(
        step=torch.zeros((), dtype=torch.int32), m=_clone(zero),
        v=_clone(zero), err=_clone(zero) if state.err is not None else None)


def _assert_same_leaves(ref_tree, port_tree):
    want = jax.tree_util.tree_leaves(ref_tree)
    got = leaves(port_tree)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    params, state = _ref_tree(compress)
    RefCheckpointer(str(tmp_path)).save(5, (params, state),
                                        extra={"loss": 1.5})
    like = _port_like(params, state)
    (p, s), step, extra = Checkpointer(str(tmp_path)).restore(like)
    assert step == 5 and extra == {"loss": 1.5}
    assert int(s.step) == 7 and s.step.dtype == torch.int32
    _assert_same_leaves((params, state), (p, s))


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    params, state = _ref_tree(compress)
    p_params, p_state = _port_like(params, state)
    rng = np.random.default_rng(2)
    p_params, p_state = tree_map(
        lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32)) if t.is_floating_point() else t + 3,
        (p_params, p_state))
    Checkpointer(str(tmp_path)).save(9, (p_params, p_state))
    (r_params, r_state), step, _ = RefCheckpointer(str(tmp_path)).restore(
        (params, state))
    assert step == 9 and int(r_state.step) == 3
    _assert_same_leaves((r_params, r_state), (p_params, p_state))


def test_elastic_restore_of_a_reference_checkpoint(tmp_path):
    """The port's counterpart of test_elastic_remesh_checkpoint: save with
    the reference's Checkpointer, ``elastic_restore`` onto the port's
    device; the leaves are equal and the model still computes."""
    cfg = get_smoke_config(ARCH).replace(remat=False)
    params = ref_build(ref_smoke(ARCH).replace(remat=False)).init_params(
        jax.random.PRNGKey(0))
    RefCheckpointer(str(tmp_path)).save(1, params)
    like = tree_map(torch.zeros_like, train_params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"))
    for mesh in (None, "cpu", [torch.device("cpu")]):
        placed, step, _ = elastic_restore(cfg, Checkpointer(str(tmp_path)),
                                          like, mesh)
        assert step == 1
        _assert_same_leaves(params, placed)
        assert all(t.device.type == "cpu" for t in leaves(placed))
    logits = build(cfg).forward(forward_params(placed, cfg),
                                torch.ones((1, 8), dtype=torch.int32))
    assert torch.isfinite(logits).all()
    loss, _ = build(cfg).loss(placed, {"tokens": torch.ones((1, 8),
                                                            dtype=torch.int32),
                                       "labels": torch.ones((1, 8),
                                                            dtype=torch.int32)})
    assert torch.isfinite(loss)


def test_a_mesh_of_several_devices_is_not_ported(tmp_path):
    """Named for what the port once did: a mesh of several devices now
    places under the training rules. A 1 x 2 ``("data", "model")`` mesh of
    the CPU gives one tree per position, whose join is the checkpoint's
    bits; a bare list of two devices names no axes and raises
    ValueError; None keeps the tree itself."""
    _, params, _, _ = _setup()
    cfg = get_smoke_config(ARCH).replace(remat=False)
    mesh = make_local_mesh(devices=["cpu", "cpu"])
    placed = reshard_params(cfg, params, mesh)
    assert isinstance(placed, Placement) and len(placed) == 2
    _assert_equal(join(placed), params)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, params)
    restored, step, _ = elastic_restore(cfg, ck, params, mesh)
    assert step == 3 and len(restored) == 2
    _assert_equal(join(restored), params)
    two = [torch.device("cpu"), torch.device("cpu")]
    with pytest.raises(ValueError, match="training rules"):
        reshard_params(cfg, params, two)
    with pytest.raises(ValueError, match="training rules"):
        elastic_restore(cfg, ck, params, two)
    assert reshard_params(cfg, params, None) is params