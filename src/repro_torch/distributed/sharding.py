"""Sharding for the port: the serving mesh's config check, and the two
across-restart re-placing helpers that ``distributed/elastic.py`` re-exports.

The reference holds its full rule tables here (``jax.sharding``). The port
has no tensor-parallel mesh yet (ROADMAP Queue 1, item 9), so it keeps
``validate_tp``, the pure config check the serving CLI runs on ``--mesh``,
and ``reshard_params`` / ``elastic_restore`` for a single-device target:
checkpoints hold logically unsharded leaves, so placing them on one device
is a move. A mesh of more than one device raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves, tree_map

__all__ = ["validate_tp", "reshard_params", "elastic_restore"]


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


def _target(mesh, tree) -> torch.device:
    """The one device ``mesh`` names: None (the device of the tree's first
    leaf), a device or its name, or a sequence holding one device."""
    if mesh is None:
        first = leaves(tree)
        return first[0].device if first else torch.device("cpu")
    if isinstance(mesh, (str, torch.device)):
        return torch.device(mesh)
    devices = list(mesh)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices needs the port's "
            "tensor-parallel placement, which is not ported yet (ROADMAP "
            "Queue 1, item 9)")
    return torch.device(devices[0])


def reshard_params(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Place a (host-resident) tree of tensors on ``mesh``: None keeps
    each leaf where it is; a device, its name or a one-device sequence
    moves every leaf there. A mesh of more than one device raises
    ``NotImplementedError`` (tensor parallelism, ROADMAP Queue 1, item
    9)."""
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
