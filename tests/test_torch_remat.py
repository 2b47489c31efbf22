"""``remat_policy="dots"`` in the port against the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, on the CPU at
f32, over one model of each family (deepseek-v2-lite for its leading
dense layer, zamba2 for the nested group checkpoints):

  * (a) the loss and every gradient leaf under "dots" equal
    ``jax.value_and_grad`` of the reference's loss under the same config;
  * (b) what each checkpoint keeps: the products the port's forward keeps
    for the backward against the residuals the reference's checkpointed
    body saves (``jax.ad_checkpoint.print_saved_residuals``), in count
    and element count, in order;
  * (c) under "dots" the backward runs as many plain products
    (``aten.mm`` / ``aten.addmm``) as with remat off; under "full" more;
  * (d) the checkpoints sit where the reference's sit: outermost and
    nested, counted against the reference's jaxpr;
  * (e) the dry-run's train cell counts less aten work under "dots" than
    under "full", by exactly the products the backward reads from the
    forward; at full size for one cell through ``--override``;
  * a kept product changed in place raises at the recompute.
"""
import contextlib
import io
import json
import math
import re
from collections import Counter

import jax
import jax.ad_checkpoint
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build as ref_build
from repro.models import encdec as ref_encdec
from repro.models import hybrid as ref_hybrid
from repro.models import ssd as ref_ssd
from repro.models import transformer as ref_transformer
from repro.models.layers import apply_mlp as ref_apply_mlp
from repro.models.layers import cast_floats
from repro.models.layers import rms_norm as ref_rms_norm
from repro_torch.configs import SHAPES_BY_NAME, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import build
from repro_torch.models import transformer
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_step import value_and_grad
from repro_torch.tree import flatten, leaves, unflatten
from repro_torch.weights import train_params_from_jax

ARCHS = ["gemma-2b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
         "mamba2-370m", "zamba2-7b", "whisper-tiny"]
LOSS_TOL = 1e-5      # test_torch_train.py's
GRAD_TOL = 1e-4      # each leaf: max |diff| <= GRAD_TOL * max(1, max |g|)
B, S = 2, 16
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config at f32."""
    return (ref_smoke(arch).replace(compute_dtype="float32", **kw),
            get_smoke_config(arch).replace(compute_dtype="float32", **kw))


def _batch(cfg, seed=1):
    return SyntheticLM(cfg, batch=B, seq=S, seed=seed,
                       device="cpu").batch_at(0)


def _live(params):
    """The tree's leaves as fresh leaves that require grad, and the tree
    over them."""
    flat, spec = flatten(params)
    live = [p.detach().requires_grad_() for p in flat]
    return live, unflatten(spec, live)


# ------------------------------------------------------ (a) the gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_grads_equal_reference(arch):
    rcfg, cfg = _cfgs(arch, remat_policy="dots")
    params = ref_build(rcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (val, met), grads = jax.jit(jax.value_and_grad(
        ref_build(rcfg).loss, has_aux=True))(
            params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    (pval, pmet), pgrads = value_and_grad(build(cfg).loss)(
        train_params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
        batch)
    assert abs(float(val) - float(pval)) <= LOSS_TOL
    for k in ("ce", "moe_aux", "moe_z"):
        assert abs(float(met[k]) - float(pmet[k])) <= LOSS_TOL, k
    want, got = jax.tree_util.tree_leaves(grads), leaves(pgrads)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL * max(1.0, np.abs(a).max())


# ---------------------------------------------------- (b) what is kept

def _jax_saved(fn, *args) -> list:
    """The element counts of the residuals ``fn``'s backward reads that are
    neither its arguments nor constants, in the order JAX lists them."""
    def scalar(*a):
        return sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(fn(*a)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(scalar, *args)
    sizes = []
    for line in buf.getvalue().splitlines():
        if re.search(r"from (the argument|a constant|a literal)", line):
            continue
        dims = re.match(r"\w+\[([\d,]*)\]", line).group(1)
        sizes.append(math.prod(int(d) for d in dims.split(",") if d))
    return sizes


def _ref_bodies(cfg):
    """The reference's checkpointed bodies, each as its ``remat_wrap``
    gives it, with one layer's params and inputs: {kind: (fn, args)}."""
    params = cast_floats(ref_build(cfg).init_params(jax.random.PRNGKey(0)),
                         "float32")
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, cfg.d_model))

    def one(tree, i=0):
        return jax.tree.map(lambda a: a[i], tree)

    def wrap(fn):
        return ref_transformer.remat_wrap(fn, cfg)

    def mamba(h, lp):
        y, _ = ref_ssd.mamba_full(
            lp["mamba"], ref_rms_norm(h, lp["norm"], cfg.norm_eps), cfg)
        return h + y

    if cfg.family == "ssm":
        return {"layer": (wrap(mamba), (x, one(params["layers"])))}
    if cfg.family == "hybrid":
        def group(h, gp):     # the reference's forward's group body
            h = ref_hybrid._shared_block_full(params["shared"], h, cfg)
            return ref_hybrid._mamba_scan(h, gp, cfg)
        return {"group": (wrap(group), (x, one(params["groups"]))),
                "layer": (wrap(mamba), (x, one(params["tail"])))}
    if cfg.is_encoder_decoder:
        enc = jax.random.normal(jax.random.PRNGKey(2),
                                (B, cfg.enc_len, cfg.d_model))

        def mlp(h, lp):
            return h + ref_apply_mlp(
                lp["mlp"], ref_rms_norm(h, lp["mlp_norm"], cfg.norm_eps),
                cfg.act)

        def enc_body(h, lp):  # repro.models.encdec.encode's body
            h = h + ref_encdec.attn_mod.gqa_full(
                lp["attn"], ref_rms_norm(h, lp["attn_norm"], cfg.norm_eps),
                cfg, causal=False)
            return mlp(h, lp)

        def dec_body(h, lp, e):  # repro.models.encdec.forward's body
            h = h + ref_encdec.attn_mod.gqa_full(
                lp["attn"], ref_rms_norm(h, lp["attn_norm"], cfg.norm_eps),
                cfg, causal=True)
            h = h + ref_encdec.attn_mod.gqa_cross(
                lp["cross"], ref_rms_norm(h, lp["cross_norm"], cfg.norm_eps),
                ref_encdec._cross_kv(lp["cross"], e, cfg), cfg)
            return mlp(h, lp)
        return {"enc": (wrap(enc_body), (enc, one(params["enc_layers"]))),
                "dec": (wrap(dec_body), (x, one(params["layers"]), enc))}

    def body(h, lp):          # repro.models.transformer.forward's body
        h, aux, _ = ref_transformer._layer_full(h, lp, cfg)
        return h, aux
    return {"layer": (wrap(body), (x, one(params["layers"])))}


def _port_kept(cfg, monkeypatch):
    """Each "dots" checkpoint of one forward of the port's loss, in the
    order they open: the products its forward keeps for the backward."""
    regions = []
    make = transformer._dots_contexts

    def recording():
        keep, replay = make()
        regions.append(keep.kept)
        return keep, replay

    monkeypatch.setattr(transformer, "_dots_contexts", recording)
    live, params = _live(build(cfg).init_train_params(seed=0, device="cpu"))
    loss, _ = build(cfg).loss(params, _batch(cfg))
    kept = [[k[0] for k in r] for r in regions]
    torch.autograd.grad(loss, live, allow_unused=True)
    return kept


def _sizes(region) -> list:
    return [t.numel() for t in region]


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_reference_saved_products(arch, monkeypatch):
    """Per checkpoint, the port keeps the products the reference saves: in
    the hybrid's group, where the reference keeps each Mamba-2 layer's
    input (its saved residual of the nested checkpoint), the port keeps
    the out_proj product of every layer but the last, from which the
    recompute rebuilds those inputs (the same width, one fewer)."""
    rcfg, cfg = _cfgs(arch, remat_policy="dots")
    ref = {kind: _jax_saved(fn, *args)
           for kind, (fn, args) in _ref_bodies(rcfg).items()}
    kept = _port_kept(cfg, monkeypatch)
    if cfg.family == "hybrid":
        g, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
        tail = cfg.n_layers - g * e
        assert len(kept) == g * (1 + e) + tail
        layer = ref["layer"]
        assert len(layer) == 1            # the in_proj product
        width = B * S * cfg.d_model
        shared = ref["group"][:-2]
        # the reference's group: the shared block's products, then its
        # nested checkpoints' residuals stacked over the E layers: the
        # in_proj products and the layer inputs
        assert ref["group"][-2:] == [e * layer[0], e * width]
        for gi in range(g):
            outer = kept[gi * (1 + e)]
            inner = kept[gi * (1 + e) + 1: (gi + 1) * (1 + e)]
            assert _sizes(outer) == shared + (layer + [width]) * (e - 1) \
                + layer
            for li, region in enumerate(inner):
                assert _sizes(region) == layer
                # the same tensor as the group's: kept once in memory
                assert region[0].untyped_storage().data_ptr() == \
                    outer[len(shared) + 2 * li].untyped_storage().data_ptr()
        for region in kept[g * (1 + e):]:
            assert _sizes(region) == layer
        return
    if cfg.is_encoder_decoder:
        want = [ref["enc"]] * cfg.n_enc_layers + [ref["dec"]] * cfg.n_layers
    else:
        want = [ref["layer"]] * (cfg.n_layers - cfg.first_dense_layers)
    assert [_sizes(r) for r in kept] == want


# ------------------------------------------- (c) no product runs twice

class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in PRODUCTS
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, params, batch) -> tuple:
    live, tree = _live(params)
    loss, _ = build(cfg).loss(tree, batch)
    with _CountProducts() as count:
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return count.n, loss.detach(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_backward_runs_no_product_twice(arch):
    _, cfg = _cfgs(arch)
    params = build(cfg).init_train_params(seed=0, device="cpu")
    batch = _batch(cfg, seed=2)
    runs = {name: _backward_products(c, params, batch) for name, c in (
        ("off", cfg.replace(remat=False)), ("full", cfg),
        ("dots", cfg.replace(remat_policy="dots")))}
    assert runs["dots"][0] == runs["off"][0] < runs["full"][0]
    assert torch.equal(runs["dots"][1], runs["full"][1])
    for a, b in zip(runs["dots"][2], runs["full"][2]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


# ------------------------------------------------------- (d) placement

def _ref_checkpoints(jaxpr, out: Counter, mult: int = 1, depth: int = 0):
    """The reference's checkpoint calls per forward by nesting depth: each
    ``jax.checkpoint`` equation (primitive ``remat2``, ``checkpoint`` in
    other JAX versions) times the trip counts of the scans around it."""
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        here = mult * (eqn.params["length"] if name == "scan" else 1)
        remat = name in ("remat2", "checkpoint")
        deeper = depth + remat
        if remat:
            out[depth] += mult
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, jax.extend.core.Jaxpr):
                    _ref_checkpoints(sub, out, here, deeper)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_sit_where_the_reference_places_them(arch,
                                                         monkeypatch):
    """Outermost and nested checkpoints per forward equal the reference's:
    deepseek-v2-lite's scanned layers without ``dense0``; zamba2's groups
    and tail layers outermost, each group's Mamba-2 layers nested."""
    rcfg, cfg = _cfgs(arch)
    params = ref_build(rcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    want = _ref_checkpoints(jax.make_jaxpr(
        lambda p, b: ref_build(rcfg).loss(p, b)[0])(
            params, {k: jnp.asarray(v.numpy())
                     for k, v in batch.items()}).jaxpr, Counter())
    got = Counter()
    depth = [0]
    checkpoint = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kwargs):
        got[depth[0]] += 1
        depth[0] += 1
        try:
            return checkpoint(fn, *args, **kwargs)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    for policy in ("full", "dots"):
        got.clear()
        live, tree = _live(build(cfg.replace(remat_policy=policy))
                           .init_train_params(seed=0, device="cpu"))
        build(cfg.replace(remat_policy=policy)).loss(tree, batch)
        assert got == want, policy
    n_scan = cfg.n_layers - cfg.first_dense_layers
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        assert want == {0: g + cfg.n_layers - g * cfg.attn_every,
                        1: g * cfg.attn_every}
    elif cfg.is_encoder_decoder:
        assert want == {0: cfg.n_enc_layers + cfg.n_layers}
    else:
        assert want == {0: n_scan}


# -------------------------------------------------------- (e) the dry-run

class _RecordKept(transformer._KeepDots):
    """The forward's keeping mode, also recording each product's output
    object and its operations (2 m n k) to sum what it keeps."""

    def __init__(self, kept):
        super().__init__(kept)
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func in transformer.DOTS:
            a, b = args[-2:]
            self.made.append((out, 2 * a.shape[0] * a.shape[1]
                              * b.shape[1]))
        return out


def _aten(cfg, shape, monkeypatch=None) -> tuple:
    """The cell's train step on ``meta`` (``dryrun.run_step``): its aten
    operations, and the unique products its "dots" checkpoints keep, with
    the operations of each."""
    modes = []
    if monkeypatch is not None:
        def recording():
            kept = []
            modes.append(_RecordKept(kept))
            return modes[-1], transformer._ReplayDots(kept)
        monkeypatch.setattr(transformer, "_dots_contexts", recording)
    _, _, stats, _ = dryrun.run_step(cfg, shape)
    unique = {}
    for m in modes:
        for out, flops in m.made[:len(m.kept)]:
            unique[id(out)] = flops
    return stats["aten_flops"], unique


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_train_cell_counts_less_work_under_dots(arch, monkeypatch):
    """At smoke size: the aten work of "full" less that of "dots" is the
    operations of the products "dots" keeps, which "full" recomputes."""
    _, cfg = _cfgs(arch)
    cfg = cfg.replace(compute_dtype="bfloat16")
    shape = ShapeConfig("train_smoke", seq_len=S, global_batch=B,
                        kind="train")
    full, _ = _aten(cfg, shape)
    dots, kept = _aten(cfg.replace(remat_policy="dots"), shape, monkeypatch)
    assert kept and full - dots == sum(kept.values())


def test_dryrun_override_dots_at_full_size():
    """gemma-2b's train_4k cell with ``--override remat_policy=dots``
    against the default: less aten work by each layer's kept forward
    products, 2 x tokens x d x (q + k + v + o + gate + up widths) x
    layers (the down product's output is read by no backward)."""
    cfg = dryrun._configure("gemma-2b", None)
    runs = {}
    for over in ({}, {"remat_policy": "dots"}):
        runs[bool(over)] = dryrun._meta_step("gemma-2b", "train_4k",
                                             json.dumps(over))[2]
    shape = SHAPES_BY_NAME["train_4k"]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    widths = (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd + d
              + 2 * cfg.d_ff)
    want = 2 * shape.global_batch * shape.seq_len * d * widths \
        * cfg.n_layers
    assert runs[False]["aten_flops"] - runs[True]["aten_flops"] == want
    assert runs[False]["kernel_flops"] == runs[True]["kernel_flops"]
    assert runs[True]["bytes_materialized"] \
        < runs[False]["bytes_materialized"]
    cell = dryrun.run_cell("gemma-2b", "train_4k", False,
                           {"remat_policy": "dots"})
    assert cell["ok"] and cell["overrides"] == {"remat_policy": "dots"}
    assert cell["memory"]["temp_size_in_bytes"] is None
    assert "temp_size_in_bytes" in cell["null_reasons"]


# --------------------------------------------- a kept product must hold

def test_kept_product_changed_in_place_raises():
    """A "dots" checkpoint's kept product changed in place after the
    forward makes the recompute raise, never pair a gradient with the
    changed value."""
    cfg = get_smoke_config("gemma-2b").replace(remat_policy="dots")
    w = torch.randn(8, 8, requires_grad=True)
    seen = []

    def fn(x):
        y = x @ w
        seen.append(y)
        return (y * y).sum(-1)

    x = torch.randn(4, 8, requires_grad=True)
    out = transformer.remat_wrap(fn, cfg)(x)
    with torch.no_grad():
        seen[0].add_(1.0)
    with pytest.raises(RuntimeError, match="remat_policy='dots'"):
        out.sum().backward()
