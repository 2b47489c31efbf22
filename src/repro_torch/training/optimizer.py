"""AdamW with global-norm clipping, the port of ``repro.training.optimizer``:
the moments are float32 trees of the params' structure, and the optional
gradient compression rounds the gradients to bf16 with a float32
error-feedback residual carried in the state (``compress``).

The reference returns new arrays; here the update runs in place, leaf by
leaf, on the params, the moments and the gradients it is given (which it
consumes), so its peak beside them is a few temporaries of one leaf (one
gemma-2b stacked MLP leaf is 2.4 GB in float32).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor              # 0-d int32
    m: Any
    v: Any
    err: Optional[Any] = None       # error-feedback residual (compression)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False    # bf16 gradients + error feedback


def init(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(zeros, params), v=tree_map(zeros, params),
        err=tree_map(zeros, params) if cfg.compress_grads else None)


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def compress(grads, err):
    """bf16 quantisation with error feedback: g_q = bf16(g + e), e' = (g +
    e) - g_q. Returns (g_q, the tree of bf16 leaves; err, its leaves
    overwritten with e'); each float32 leaf of ``grads`` is overwritten
    with g + e."""
    def one(g, e):
        corrected = g.float().add_(e)
        q = corrected.to(torch.bfloat16)
        torch.sub(corrected, q, out=e)
        return q
    return tree_map(one, grads, err), err


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: clip the gradients to ``clip_norm`` by their global
    norm, then update the step counter, the moments and the params in
    place. Returns (params, the new state, {"grad_norm"}); the tensors of
    the old state are the new state's, so a CUDA graph captured over one
    state keeps counting steps on every replay."""
    err = state.err
    if cfg.compress_grads:
        grads, err = compress(grads, err)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step.add_(1)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float().mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
        delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta.mul_(cfg.lr))      # in p's dtype, from float32
    return params, AdamWState(step, state.m, state.v, err), \
        {"grad_norm": gnorm}
