"""The port's training placement rules against the reference's, on both
production meshes, and the meshes and restore they drive.

The reference's rules run on ``jax.sharding.AbstractMesh`` (16x16 and
2x16x16: no devices needed) over its ``abstract_params`` /
``abstract_decode_state``; the port's on ``launch.mesh
.make_production_mesh`` (every position on ``meta``) over its own, built on
``meta``. A port spec equals ``tuple(P(...))`` of the reference's:

  * ``param_pspec`` (with ``param_shardings`` and ``opt_state_shardings``)
    on every leaf of every ``ARCH_IDS`` member;
  * ``batch_axes`` over batches 1-512 and ``batch_shardings`` of every
    cell's inputs;
  * ``decode_state_pspec`` at ``decode_32k`` and ``long_500k``;
  * a checkpoint the reference's ``Checkpointer`` wrote, restored onto a
    2x2 ``("data", "model")`` mesh of repeated CPU devices: one tree per
    position, each slice where the rules put it, joined to the bits;
  * ``maybe_constrain`` is the identity with and without a mesh.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import input_specs as ref_input_specs
from repro.distributed import sharding as ref
from repro.models import abstract_decode_state as ref_abstract_state
from repro.models import abstract_params as ref_abstract_params
from repro.models import build as ref_build
from repro.training import optimizer as ref_opt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import (ARCH_IDS, SHAPES, SHAPES_BY_NAME,
                                 get_config, get_smoke_config, input_specs)
from repro_torch.distributed import maybe_constrain, sharding
from repro_torch.launch.mesh import (Mesh, active_mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import abstract_decode_state, abstract_params
from repro_torch.training import optimizer as opt
from repro_torch.tree import leaves

MESHES = {"16x16": False, "2x16x16": True}


def _meshes(name):
    """(reference AbstractMesh, port mesh) of one production shape."""
    multi = MESHES[name]
    dims, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                  else ((16, 16), ("data", "model")))
    return AbstractMesh(dims, axes), make_production_mesh(multi_pod=multi)


def _ref_specs(tree, spec_fn):
    """{path: tuple(spec)} over a reference tree; ``spec_fn(path, leaf)``
    returns a PartitionSpec or a NamedSharding."""
    out = {}

    def visit(path, leaf):
        spec = spec_fn(path, leaf)
        out[ref._path_str(path)] = tuple(getattr(spec, "spec", spec))

    jax.tree_util.tree_map_with_path(visit, tree)
    return out


def _port_specs(tree, spec_fn):
    out = {}
    sharding._map_with_path(
        lambda name, leaf: out.__setitem__(name, spec_fn(name, leaf)), tree)
    return out


def _shard_specs(tree):
    """{path: spec} of a port tree of ``(mesh, spec)``."""
    out = {}

    def walk(t, path):
        if isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], Mesh):
            out[path] = t[1]
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
    walk(tree, "")
    return out


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_match_reference(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = ref_config(arch), get_config(arch)
    jparams, params = ref_abstract_params(jcfg), abstract_params(cfg)
    want = _ref_specs(jparams, lambda p, l: ref.param_pspec(jcfg, jmesh, p,
                                                            l))
    got = _port_specs(params, lambda n, l: sharding.param_pspec(cfg, mesh, n,
                                                                l))
    assert got == want
    assert _shard_specs(sharding.param_shardings(cfg, mesh, params)) == want
    # the optimizer state: moments mirror the params, the step replicated
    jstate = jax.eval_shape(lambda p: ref_opt.init(p, ref_opt.AdamWConfig()),
                            jparams)
    jshard = ref.opt_state_shardings(jcfg, jmesh, jstate, jparams)
    state = opt.init(params, opt.AdamWConfig())
    shard = sharding.opt_state_shardings(cfg, mesh, state, params)
    assert type(shard).__name__ == "AdamWState" and shard.err is None
    assert shard.step == (mesh, ()) == (mesh, tuple(jshard.step.spec))
    for field in ("m", "v"):
        assert _shard_specs(getattr(shard, field)) == _ref_specs(
            getattr(jshard, field), lambda p, s: s)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_axes_and_shardings_match_reference(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    for b in range(1, 513):
        assert sharding.batch_axes(mesh, b) == ref.batch_axes(jmesh, b), b
    for arch in ARCH_IDS:
        jcfg, cfg = ref_config(arch), get_config(arch)
        for shape in SHAPES:
            want = ref.batch_shardings(jcfg, jmesh,
                                       ref_input_specs(jcfg, shape))
            got = sharding.batch_shardings(cfg, mesh,
                                           input_specs(cfg, shape))
            assert set(got) == set(want)
            for k, (m, spec) in got.items():
                assert m is mesh and spec == tuple(want[k].spec), (arch, k)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_match_reference(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = ref_config(arch), get_config(arch)
    for shape in (SHAPES_BY_NAME["decode_32k"], SHAPES_BY_NAME["long_500k"]):
        b, s = shape.global_batch, shape.seq_len
        jstate = ref_abstract_state(jcfg, b, s)
        state = abstract_decode_state(cfg, b, s)
        want = _ref_specs(jstate, lambda p, l: ref.decode_state_pspec(
            jcfg, jmesh, p, l))
        got = _port_specs(state, lambda n, l: sharding.decode_state_pspec(
            cfg, mesh, n, l))
        assert got == want, shape.name
        assert _shard_specs(sharding.decode_state_shardings(
            cfg, mesh, state)) == want
        assert all(t.device.type == "meta" for t in leaves(state))


def test_production_and_local_meshes():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert set(single.flat_devices) == {torch.device("meta")}
    assert len(multi.devices) == 2 and len(multi.devices[1][15]) == 16
    coords = [c for c, _ in single.positions()]
    assert coords[0] == {"data": 0, "model": 0}
    assert coords[17] == {"data": 1, "model": 1}
    local = make_local_mesh("cpu")
    assert local.shape == {"data": 1, "model": 1}
    two = make_local_mesh(devices=["cpu", "cpu"])
    assert two.shape == {"data": 1, "model": 2}
    assert two.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_maybe_constrain_is_the_identity():
    x = torch.arange(32.0).reshape(16, 2)
    assert active_mesh() is None
    assert maybe_constrain(x, ("data", None)) is x
    mesh = make_production_mesh()
    with mesh:
        assert active_mesh() is mesh
        assert maybe_constrain(x, ("data", None)) is x
        assert maybe_constrain(x, (None, "model")) is x
    assert active_mesh() is None


def test_restore_onto_a_2x2_mesh_of_a_reference_checkpoint(tmp_path):
    """The reference saves its smoke gemma-2b params; the port restores
    them onto a 2x2 ("data", "model") mesh of the CPU. Each position holds
    its slice under ``param_pspec``; a slice shared by positions on one
    device is one tensor; the join equals the reference's values."""
    arch = "gemma-2b"
    jcfg = ref_smoke(arch).replace(remat=False)
    cfg = get_smoke_config(arch).replace(remat=False)
    jparams = ref_build(jcfg).init_params(jax.random.PRNGKey(0))
    RefCheckpointer(str(tmp_path)).save(4, jparams)
    mesh = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    like = abstract_params(cfg)
    placed, step, _ = sharding.elastic_restore(
        cfg, Checkpointer(str(tmp_path)), like, mesh)
    assert step == 4 and isinstance(placed, sharding.Placement)
    assert len(placed) == 4
    flat = {}
    jax.tree_util.tree_map_with_path(
        lambda p, l: flat.__setitem__(ref._path_str(p), np.asarray(l)),
        jparams)
    n_split = 0
    for i, (coords, _) in enumerate(mesh.positions()):
        got = _port_specs(placed[i], lambda n, l: l)
        for name, piece in got.items():
            spec = sharding.param_pspec(cfg, mesh, name, _leaf(like, name))
            sl = sharding.spec_slices(mesh, coords, flat[name].shape, spec)
            want = flat[name][tuple(slice(lo, hi) for lo, hi in sl)]
            assert tuple(piece.shape) == want.shape, name
            np.testing.assert_array_equal(piece.numpy(), want)
            n_split += any(e is not None for e in spec)
    assert n_split > 0
    # a replicated leaf is one tensor at every position of the one device
    assert placed[0]["final_norm"] is placed[3]["final_norm"]
    joined = sharding.join(placed)
    for name, t in _port_specs(joined, lambda n, l: l).items():
        np.testing.assert_array_equal(t.numpy(), flat[name])
