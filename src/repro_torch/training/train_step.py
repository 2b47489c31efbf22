"""The training step, the port of ``repro.training.train_step``: loss ->
gradients -> clip -> AdamW. ``value_and_grad`` is the counterpart of
``jax.value_and_grad(model.loss, has_aux=True)`` over a master tree."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten, unflatten


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` -> a function of the
    same arguments returning ((loss, metrics), grads): grads a tree of
    params' structure, zeros for a leaf the loss does not reach. The params
    are not modified, and need not require grad."""
    def fn(params, batch):
        flat, spec = flatten(params)
        live = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(spec, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten(spec, grads)
    return fn


def make_train_step(cfg: ModelConfig,
                    ocfg: opt.AdamWConfig = opt.AdamWConfig()):
    """-> train_step(params, state, batch) -> (params, state, metrics):
    metrics are ``loss`` and the model's (``ce``, ``moe_aux``, ``moe_z``)
    and ``grad_norm``, 0-d tensors. params and state are updated in
    place."""
    grad_fn = value_and_grad(build(cfg).loss)

    def train_step(params, state: opt.AdamWState, batch: Dict[str, Any]
                   ) -> Tuple[Any, opt.AdamWState, Dict[str, torch.Tensor]]:
        (loss, metrics), grads = grad_fn(params, batch)
        params, state, om = opt.update(grads, state, params, ocfg)
        return params, state, dict(metrics, loss=loss, **om)

    return train_step


def make_serve_steps(cfg: ModelConfig):
    """(prefill_step, decode_step) at the serving shapes, on prepared
    params: prefill_step(params, batch) -> the last position's logits
    (b, 1, V); decode_step(params, state, token, cache_len) -> (b, 1, V),
    ``state`` updated in place."""
    model = build(cfg)
    inputs = ("patch_embeds", "frame_embeds")

    @torch.no_grad()
    def prefill_step(params, batch):
        extra = {k: batch[k] for k in inputs if k in batch}
        return model.forward(params, batch["tokens"], **extra)[:, -1:]

    @torch.no_grad()
    def decode_step(params, state, token, cache_len):
        return model.decode_step(params, state, token, cache_len)

    return prefill_step, decode_step
