"""Sharding for the port: the training rules over the ``(pod, data,
model)`` mesh, the serving rules of the tensor-parallel megastep
(DESIGN.md §13), and the re-placing helpers that ``distributed/elastic.py``
re-exports.

torch has no ``PartitionSpec``: a spec is a tuple with one entry per
dimension, an axis name, a tuple of axis names or None, equal to
``tuple(P(...))`` of the reference's (so a one-axis tuple is the axis
name). A "sharding" is ``(mesh, spec)``: torch has no ``NamedSharding``.
The two rule families:

  * training/dry-run rules (``param_pspec`` and friends, the dry-run's):
    name-based over tree paths; every rule gives the trailing dims, and
    leading stack dims (stacked layers / hybrid groups) get None. Dims that
    don't divide the mesh axis stay unsharded (never silently uneven);
  * serving rules over the 1-D ``("tp",)`` mesh of
    ``launch.mesh.make_tp_mesh``: ``kv_pool_pspec`` /
    ``megastep_input_pspecs`` / ``megastep_output_pspec`` and
    ``serving_param_pspec(s)``; ``tp_head_order`` / ``permute_attn_heads``
    relabel the query heads so contiguous per-shard slices keep the global
    GQA pairing; ``shard_serving_params`` cuts the params into one tree per
    shard. These are strict: a dimension that ``tp`` does not divide
    raises ValueError, never a silent replication.

``reshard_params`` / ``elastic_restore`` place a tree under the training
rules: one tree per mesh position, each holding its slice of every leaf,
and ``join`` rebuilds the logical tree from them.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves, tree_map

DP, MP, POD = "data", "model", "pod"
TP = "tp"                     # the serving megastep's tensor-parallel axis

__all__ = ["DP", "MP", "POD", "TP", "param_pspec", "param_shardings",
           "batch_axes", "batch_shardings", "decode_state_pspec",
           "decode_state_shardings", "opt_state_shardings", "kv_pool_pspec",
           "megastep_input_pspecs",
           "megastep_output_pspec", "validate_tp", "tp_head_order",
           "permute_attn_heads", "serving_param_pspec",
           "serving_param_pspecs", "shard_serving_params", "reshard_params",
           "elastic_restore", "Placement", "join", "spec_slices"]

Spec = Tuple[Any, ...]


def _map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` joins the
    keys and list indices with "/" (the reference's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}" if path
                                         else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# --------------------------------------------------------------------------
# Training / dry-run rules over the (pod, data, model) mesh
# --------------------------------------------------------------------------

# rule table: path-regex -> trailing-dims spec template using DP/MP markers.
# the first matching rule wins.
_PARAM_RULES = [
    (r"embed$", (MP, DP)),
    (r"lm_head$", (DP, MP)),
    (r"(dec_pos|enc_pos)$", (None, DP)),
    (r"(kv_norm|norm|attn_norm|mlp_norm|cross_norm|final_norm|enc_final_norm)$",
     (None,)),
    # attention
    (r"attn/w(q|k|v)$", (DP, MP)),
    (r"cross/w(q|k|v)$", (DP, MP)),
    (r"(attn|cross)/wo$", (MP, DP)),
    # MLA
    (r"attn/w_dkv$", (DP, None)),
    (r"attn/w_u(k|v)$", (None, MP)),
    # dense MLP
    (r"mlp/w_(gate|up)$", (DP, MP)),
    (r"mlp/w_down$", (MP, DP)),
    # MoE: experts over MP (expert parallelism), router replicated-on-MP
    (r"moe/router$", (DP, None)),
    (r"moe/w_(gate|up)$", (MP, DP, None)),
    (r"moe/w_down$", (MP, None, DP)),
    (r"moe/shared/w_(gate|up)$", (DP, MP)),
    (r"moe/shared/w_down$", (MP, DP)),
    # Mamba
    (r"mamba/in_proj$", (DP, MP)),
    (r"mamba/conv_w$", (None, MP)),
    (r"mamba/conv_b$", (MP,)),
    (r"mamba/(A_log|D|dt_bias)$", (MP,)),
    (r"mamba/out_proj$", (MP, DP)),
]


def _axis_ok(mesh, axis: Optional[str], dim: int) -> Optional[str]:
    if axis is None:
        return None
    return axis if dim % mesh.shape[axis] == 0 else None


def _entry(axes):
    """A spec entry as ``P`` normalises it: a one-axis tuple is the axis."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def param_pspec(cfg: ModelConfig, mesh, name: str, leaf) -> Spec:
    """The spec of the param at path ``name`` ("layers/attn/wq") on
    ``mesh``. Reads only ``leaf.shape``."""
    ndim = len(leaf.shape)
    # kv projections: a 16-way shard of hkv*hd is only expressible as a
    # head-major tiling when hkv divides the mesh axis; otherwise the
    # whole attention computation would replicate at the (hkv, hd)
    # reshape. Replicating the small kv projection across `model` avoids
    # that.
    if re.search(r"attn/w(k|v)$", name) and cfg.n_kv_heads and \
            cfg.n_kv_heads % mesh.shape[MP] != 0:
        t = 2
        lead = (None,) * (ndim - t)
        return lead + (_axis_ok(mesh, DP, leaf.shape[-2]), None)
    for pat, template in _PARAM_RULES:
        if re.search(pat, name):
            t = len(template)
            lead = (None,) * (ndim - t)
            dims = tuple(_axis_ok(mesh, ax, leaf.shape[ndim - t + i])
                         for i, ax in enumerate(template))
            return lead + dims
    return ()                        # replicate by default (norm scales etc.)


def param_shardings(cfg: ModelConfig, mesh, params_tree) -> Any:
    """The tree of ``(mesh, spec)`` over a param tree."""
    return _map_with_path(
        lambda name, leaf: (mesh, param_pspec(cfg, mesh, name, leaf)),
        params_tree)


def batch_axes(mesh, batch: int):
    """Largest (pod?, data) product that divides the global batch."""
    if POD in mesh.shape:
        if batch % (mesh.shape[POD] * mesh.shape[DP]) == 0:
            return (POD, DP)
        if batch % mesh.shape[POD] == 0:
            return (POD,)
    if batch % mesh.shape[DP] == 0:
        return (DP,)
    return None


def batch_shardings(cfg: ModelConfig, mesh, specs: Dict[str, Any]) -> Any:
    """``(mesh, spec)`` per input: the batch dim over ``batch_axes``, the
    rest replicated; a 0-d input replicated."""
    out = {}
    for k, t in specs.items():
        if len(t.shape) == 0:
            out[k] = (mesh, ())
            continue
        ba = batch_axes(mesh, t.shape[0])
        out[k] = (mesh, (_entry(ba),) + (None,) * (len(t.shape) - 1))
    return out


def decode_state_pspec(cfg: ModelConfig, mesh, name: str, leaf) -> Spec:
    """KV caches: batch over data, sequence over model (sequence-parallel
    cache: the KV tensor is the dominant decode working set). SSM states:
    heads/channels over model."""
    ndim = len(leaf.shape)

    # locate the batch dim: stacked layer caches are (L, B, ...) or hybrid
    # (G, E, B, ...); whisper cross caches (L, B, S, h, hd)
    def spec_for(dims_after_stack, batch_pos):
        lead = [None] * batch_pos
        b = leaf.shape[batch_pos]
        lead.append(batch_axes(mesh, b) and DP if b % mesh.shape[DP] == 0
                    else None)
        rest = [None] * (ndim - batch_pos - 1)
        return lead, rest

    if re.search(r"(^|/)(k|v|ckv|krope|cross_k|cross_v|attn_k|attn_v)\d?$",
                 name):
        stack = 1 if not name.startswith(("ckv0", "krope0")) else 0
        if name in ("ckv0", "krope0"):
            stack = 0
        lead, rest = spec_for(None, stack)
        # sequence dim right after batch
        seq_idx = stack + 1
        rest = [None] * (ndim - stack - 1)
        if leaf.shape[seq_idx] % mesh.shape[MP] == 0:
            rest[0] = MP
        return tuple(lead + rest)
    if re.search(r"(conv|tail_conv)$", name):
        spec = [None] * ndim
        if leaf.shape[-1] % mesh.shape[MP] == 0:
            spec[-1] = MP
        b_idx = ndim - 3
        if leaf.shape[b_idx] % mesh.shape[DP] == 0:
            spec[b_idx] = DP
        return tuple(spec)
    if re.search(r"(ssm|tail_ssm)$", name):
        # (..., B, g, hg, n, p): shard hg over model
        spec = [None] * ndim
        if leaf.shape[-3] % mesh.shape[MP] == 0:
            spec[-3] = MP
        b_idx = ndim - 5
        if leaf.shape[b_idx] % mesh.shape[DP] == 0:
            spec[b_idx] = DP
        return tuple(spec)
    return ()


def decode_state_shardings(cfg: ModelConfig, mesh, state_tree) -> Any:
    return _map_with_path(
        lambda name, leaf: (mesh, decode_state_pspec(cfg, mesh, name, leaf)),
        state_tree)


def opt_state_shardings(cfg: ModelConfig, mesh, opt_tree, params_tree):
    """Moments mirror the param layout (ZeRO); step scalar replicated.
    Returns an ``AdamWState`` of sharding trees."""
    from repro_torch.training.optimizer import AdamWState
    pshard = param_shardings(cfg, mesh, params_tree)
    return AdamWState(step=(mesh, ()), m=pshard, v=pshard,
                      err=pshard if opt_tree.err is not None else None)


# --------------------------------------------------------------------------
# Serving: tensor-parallel specs for the sharded megastep (DESIGN.md §13)
# --------------------------------------------------------------------------

def kv_pool_pspec() -> Spec:
    """Paged KV pool ``(L, num_blocks, blk, hkv, hd)``: KV heads over
    ``tp``, everything else local. Block ids (and therefore page tables)
    are shard-invariant: every shard holds the SAME blocks for its own
    head slice, so one host-side page table per sequence drives all
    shards."""
    return (None, None, None, TP, None)


def megastep_input_pspecs() -> Tuple[Spec, Spec, Spec, Spec, Spec]:
    """Megastep row inputs (``tokens (B, C)``, ``cache_lens (B,)``,
    ``valids (B,)``, ``page_tables (B, npages)``, ``poison_mask (B,)``)
    are all replicated: every shard sees the full batch and computes its
    head slice of it."""
    return ((), (), (), (), ())


def megastep_output_pspec() -> Spec:
    """The sampled ``(B,)`` int32 vector: replicated. The per-layer sum of
    the attention partials restores the full residual stream on every
    device, so only one (B,) vector crosses to the host."""
    return ()


def validate_tp(cfg: ModelConfig, tp: int):
    """The divisibility contract behind contiguous per-shard head slices.
    Raised as ValueError so launchers can surface it as a CLI error."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide n_kv_heads={cfg.n_kv_heads}: the "
            "paged KV pool shards whole KV heads, so tp must divide hkv")
    if cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide n_heads={cfg.n_heads}")


def tp_head_order(cfg: ModelConfig, tp: int) -> Optional[List[int]]:
    """Query-head order that makes CONTIGUOUS per-shard column slices of
    ``wq`` (and row slices of ``wo``) reproduce the global GQA pairing.

    Under ``gqa_mode == "tiled"`` q head ``h`` pairs with kv head
    ``h % hkv`` (g-major). Shard ``i`` owns kv heads
    ``[i*hkv/tp, (i+1)*hkv/tp)``, so its q heads are strided through the
    global head axis; this permutation gathers them contiguous, ordered so
    the LOCAL g-major pairing (against the local kv slice) is exactly the
    global pairing. None (the identity) when ``tp == 1``, which is what
    makes the TP=1 mesh bitwise identical to the single-device engine, and
    under ``gqa_mode == "grouped"`` (kv-major), where contiguous slices
    already pair correctly."""
    validate_tp(cfg, tp)
    if tp == 1 or cfg.gqa_mode != "tiled":
        return None
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g, hkv_l = hq // hkv, hkv // tp
    return [g_idx * hkv + i * hkv_l + kv_l
            for i in range(tp)
            for g_idx in range(g)
            for kv_l in range(hkv_l)]


def permute_attn_heads(cfg: ModelConfig, tp: int, params):
    """Reorder ``wq`` columns / ``wo`` rows per ``tp_head_order`` so the
    sharding below can slice heads contiguously. A pure relabeling of the
    head axis: wq and wo move together, so ``(x @ wq) ... @ wo`` is
    unchanged. Returns ``params`` itself when the order is the identity;
    otherwise a new tree sharing every other leaf."""
    order = tp_head_order(cfg, tp)
    if order is None:
        return params
    hd = cfg.resolved_head_dim

    def fix(name, leaf):
        if re.search(r"attn/wq$", name):
            *lead, d, cols = leaf.shape
            w = leaf.reshape(*lead, d, cols // hd, hd)
            idx = torch.tensor(order, device=leaf.device)
            return w.index_select(len(lead) + 1, idx).reshape(leaf.shape)
        if re.search(r"attn/wo$", name):
            *lead, rows, d = leaf.shape
            w = leaf.reshape(*lead, rows // hd, hd, d)
            idx = torch.tensor(order, device=leaf.device)
            return w.index_select(len(lead), idx).reshape(leaf.shape)
        return leaf

    return _map_with_path(fix, params)


# serving rule table (megastep / GQA family only): wq columns and wo rows
# shard over tp (head-major, post-permutation), wk/wv columns shard over tp
# (whole KV heads: contiguous slices pair correctly in both gqa modes),
# everything else (embed, norms, MLP or MoE, unembed) replicates: the
# per-layer sum of the attention partials keeps every device's residual
# stream identical, so the argmax needs no final reduction.
_TP_SERVING_RULES = [
    (r"attn/w(q|k|v)$", (None, TP)),
    (r"attn/wo$", (TP, None)),
]


def serving_param_pspec(cfg: ModelConfig, tp: int, name: str, leaf) -> Spec:
    """The spec of the leaf at path ``name`` ("layers/0/attn/wq"): its
    trailing dims from the rule table, None on every leading (stacked)
    dim; () (replicated) for every leaf no rule names. Reads only
    ``leaf.shape``, so numpy arrays and tensors alike."""
    ndim = len(leaf.shape)
    for pat, template in _TP_SERVING_RULES:
        if re.search(pat, name):
            t = len(template)
            for i, ax in enumerate(template):
                if ax is not None and leaf.shape[ndim - t + i] % tp:
                    raise ValueError(
                        f"{name}: dim {leaf.shape[ndim - t + i]} not "
                        f"divisible by tp={tp}")
            return (None,) * (ndim - t) + template
    return ()


def serving_param_pspecs(cfg: ModelConfig, tp: int, params_tree) -> Any:
    """The tree of specs over the serving params: how
    ``shard_serving_params`` cuts each leaf."""
    return _map_with_path(
        lambda name, leaf: serving_param_pspec(cfg, tp, name, leaf),
        params_tree)


def shard_serving_params(cfg: ModelConfig, mesh, params):
    """Cut the serving params for ``mesh``: permute the attention heads
    for its ``tp`` factor (once), slice every leaf a rule shards
    contiguously (shard ``i`` takes the ``i``-th of ``tp`` equal parts of
    the sharded dim) onto shard ``i``'s device, and place every replicated
    leaf once per DISTINCT device of the mesh (a leaf already there is not
    copied; shards on one device share it). Returns one param tree per
    shard, in shard order."""
    tp = mesh.shape[TP]
    params = permute_attn_heads(cfg, tp, params)
    placed_once: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def shard(i: int, dev: torch.device):
        def cut(name, leaf):
            spec = serving_param_pspec(cfg, tp, name, leaf)
            if TP in spec:
                dim = spec.index(TP)
                n = leaf.shape[dim] // tp
                return leaf.narrow(dim, i * n, n).to(dev).contiguous()
            key = (id(leaf), dev)
            if key not in placed_once:
                placed_once[key] = leaf.to(dev)
            return placed_once[key]
        return _map_with_path(cut, params)

    return [shard(i, dev) for i, dev in enumerate(mesh.devices)]


# --------------------------------------------------------------------------
# Elastic re-mesh: place a tree under the training rules
# --------------------------------------------------------------------------

def spec_slices(mesh, coords: Dict[str, int], shape, spec: Spec
                ) -> Tuple[Tuple[int, int], ...]:
    """The ``(start, stop)`` of every dim of a leaf of ``shape`` held at
    the mesh position ``coords`` under ``spec``: a dim split over axes
    (one, or a tuple taken row-major) gives the position its equal part;
    an unsplit dim, the whole."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        size = n // parts
        out.append((idx * size, (idx + 1) * size))
    return tuple(out)


def _devices(mesh) -> Tuple[torch.device, ...]:
    """The positions' devices, row-major, of a mesh or a sequence."""
    devs = getattr(mesh, "flat_devices", None)
    if devs is None:
        devs = getattr(mesh, "devices", mesh)
    return tuple(torch.device(d) for d in devs)


def _single(mesh) -> Optional[torch.device]:
    """The one device ``mesh`` names (a device or its name, or a mesh or
    sequence of one position), or None for a mesh of several positions.
    A bare sequence of several devices, or a ``("tp",)`` mesh of several
    shards, has no training axes and raises ValueError."""
    if isinstance(mesh, (str, torch.device)):
        return torch.device(mesh)
    devices = _devices(mesh)
    if len(devices) == 1:
        return devices[0]
    axes = tuple(getattr(mesh, "axis_names", ()))
    if DP not in axes or MP not in axes:
        raise ValueError(
            f"{len(devices)} devices with axes {axes}: the training rules "
            f"place over a mesh with '{DP}' and '{MP}' axes "
            "(launch.mesh.make_local_mesh / make_production_mesh); a "
            "('tp',) mesh takes shard_serving_params")
    return None


class Placement(list):
    """``reshard_params``' result on a mesh of several positions: one tree
    per position, in the mesh's row-major order. ``mesh`` and ``specs``
    (path -> (logical shape, spec)) are what ``join`` reads."""

    def __init__(self, trees, mesh, specs: Dict[str, Tuple]):
        super().__init__(trees)
        self.mesh = mesh
        self.specs = specs


def reshard_params(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Place a (host-resident) tree of tensors on ``mesh`` under the
    training rules (``param_pspec``). None keeps each leaf where it is; a
    device, its name or a mesh of one position moves every leaf there.
    A mesh of several positions gives a ``Placement``: one tree per
    position, in the mesh's row-major order, each holding its slice of
    every leaf; a slice that several positions on one device share is
    placed there once (a replicated leaf once per distinct device). Rules
    degrade gracefully (dims that stop dividing the new axis sizes fall
    back to replication), which is what makes shrink-to-fewer-hosts
    restarts safe. ``join`` rebuilds the logical tree."""
    if mesh is None:
        return params
    dev = _single(mesh)
    if dev is not None:
        return tree_map(lambda t: t.to(dev), params)
    specs: Dict[str, Tuple] = {}
    placed: Dict[Tuple, torch.Tensor] = {}

    def position(coords, dev):
        def cut(name, leaf):
            if name not in specs:
                specs[name] = (tuple(leaf.shape),
                               param_pspec(cfg, mesh, name, leaf))
            sl = spec_slices(mesh, coords, leaf.shape, specs[name][1])
            key = (id(leaf), dev, sl)
            if key not in placed:
                part = leaf
                for dim, (lo, hi) in enumerate(sl):
                    if hi - lo != leaf.shape[dim]:
                        part = part.narrow(dim, lo, hi - lo)
                placed[key] = (leaf.to(dev) if part is leaf
                               else part.to(dev).contiguous())
            return placed[key]
        return _map_with_path(cut, params)

    trees = [position(coords, dev) for coords, dev in mesh.positions()]
    return Placement(trees, mesh, specs)


def join(placed) -> Any:
    """The logical tree of a ``Placement``: every leaf assembled from its
    positions' slices on the first position's device. Any other tree
    (``reshard_params``' result for None or one device) is returned as it
    is."""
    if not isinstance(placed, Placement):
        return placed
    mesh = placed.mesh
    positions = [c for c, _ in mesh.positions()]
    dev = _devices(mesh)[0]
    by_path = [{} for _ in placed]
    for i, tree in enumerate(placed):
        _map_with_path(lambda name, leaf, i=i: by_path[i].__setitem__(
            name, leaf), tree)

    def whole(name, first):
        shape, spec = placed.specs[name]
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for coords, pieces in zip(positions, by_path):
            sl = spec_slices(mesh, coords, shape, spec)
            out[tuple(slice(lo, hi) for lo, hi in sl)] = pieces[name]
        return out

    return _map_with_path(whole, placed[0])


def elastic_restore(cfg: ModelConfig, checkpointer, like: Any, mesh,
                    step=None):
    """Restore a checkpoint (the latest, or ``step``) into the structure
    of ``like`` and place it on ``mesh`` as ``reshard_params`` does (None:
    the device of ``like``'s leaves). Checkpoints store logically-unsharded
    arrays, so elastic scaling is purely a placement problem. Returns
    (placed, step, extra)."""
    if mesh is None:
        first = leaves(like)
        mesh = first[0].device if first else torch.device("cpu")
    _single(mesh)                   # a mesh without training axes raises
    tree, step, extra = checkpointer.restore(like, step=step)
    return reshard_params(cfg, tree, mesh), step, extra
