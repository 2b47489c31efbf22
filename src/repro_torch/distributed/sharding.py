"""Sharding for the port: the serving rules of the tensor-parallel megastep
(DESIGN.md §13), and the two across-restart re-placing helpers that
``distributed/elastic.py`` re-exports.

The reference holds two rule families here (``jax.sharding``). The port
keeps the serving one, over the 1-D ``("tp",)`` mesh of
``launch.mesh.make_tp_mesh``:

  * ``kv_pool_pspec`` / ``megastep_input_pspecs`` / ``megastep_output_pspec``
    and ``serving_param_pspec(s)`` name how each tensor is split. torch has
    no ``PartitionSpec``: a spec is a tuple of axis names or None, one per
    dimension, equal to ``tuple(P(...))`` of the reference's;
  * ``tp_head_order`` / ``permute_attn_heads`` relabel the query heads so
    contiguous per-shard slices keep the global GQA pairing;
  * ``shard_serving_params`` cuts the params into one tree per shard.

The rules are strict: a dimension that ``tp`` does not divide raises
ValueError, never a silent replication. The training rules (``param_pspec``
and friends, the dry-run's) are a later slice of the port, so
``reshard_params`` / ``elastic_restore`` place a tree on one device and
refuse a mesh of several.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves, tree_map

TP = "tp"                     # the serving megastep's tensor-parallel axis

__all__ = ["TP", "kv_pool_pspec", "megastep_input_pspecs",
           "megastep_output_pspec", "validate_tp", "tp_head_order",
           "permute_attn_heads", "serving_param_pspec",
           "serving_param_pspecs", "shard_serving_params", "reshard_params",
           "elastic_restore"]

Spec = Tuple[Optional[str], ...]


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
# Elastic re-mesh: one device only until the training rules are ported
# --------------------------------------------------------------------------

def _target(mesh, tree) -> torch.device:
    """The one device ``mesh`` names: None (the device of the tree's first
    leaf), a device or its name, a ``TPMesh`` or a sequence holding one
    device."""
    if mesh is None:
        first = leaves(tree)
        return first[0].device if first else torch.device("cpu")
    if isinstance(mesh, (str, torch.device)):
        return torch.device(mesh)
    devices = list(getattr(mesh, "devices", mesh))
    if len(devices) != 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices needs the training placement "
            "rules (the reference's param_pspec), a later slice of the port "
            "(ROADMAP Queue 1, item 9)")
    return torch.device(devices[0])


def reshard_params(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Place a (host-resident) tree of tensors on ``mesh``: None keeps
    each leaf where it is; a device, its name or a one-device mesh moves
    every leaf there. A mesh of more than one device raises
    ``NotImplementedError``: that placement takes the training rules."""
    if mesh is None:
        return params
    dev = _target(mesh, params)
    return tree_map(lambda t: t.to(dev), params)


def elastic_restore(cfg: ModelConfig, checkpointer, like: Any, mesh,
                    step=None):
    """Restore a checkpoint (the latest, or ``step``) into the structure
    of ``like`` and place it on ``mesh`` (None: the device of ``like``'s
    leaves). Returns (placed_tree, step, extra)."""
    dev = _target(mesh, like)
    tree, step, extra = checkpointer.restore(like, step=step)
    return reshard_params(cfg, tree, dev), step, extra
