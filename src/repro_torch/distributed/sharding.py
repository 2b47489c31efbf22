"""Sharding for the port: the serving mesh's config check, and the two
across-restart re-meshing helpers that ``distributed/elastic.py`` re-exports.

The reference holds its full rule tables here (``jax.sharding``). The port
has neither a tensor-parallel mesh nor a checkpointer yet, so it keeps only
``validate_tp``, the pure config check the serving CLI runs on ``--mesh``.
``reshard_params`` and ``elastic_restore`` raise until the port has a mesh
(ROADMAP Queue 1, item 9) and a checkpointer (item 10).
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig

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


def reshard_params(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Place a param tree onto ``mesh``: needs the port's tensor-parallel
    mesh, which is not ported yet."""
    raise NotImplementedError(
        "reshard_params needs a tensor-parallel mesh, which the port does "
        "not have yet (ROADMAP Queue 1, item 9)")


def elastic_restore(cfg: ModelConfig, checkpointer, like: Any, mesh,
                    step=None):
    """Restore the latest checkpoint onto ``mesh``: needs the port's
    checkpointer and mesh, which are not ported yet."""
    raise NotImplementedError(
        "elastic_restore needs a checkpointer and a tensor-parallel mesh, "
        "which the port does not have yet (ROADMAP Queue 1, items 9 and "
        "10)")
