"""The training step, the port of ``repro.training.train_step``: loss ->
gradients -> clip -> AdamW. ``value_and_grad`` is the counterpart of
``jax.value_and_grad(model.loss, has_aux=True)`` over a master tree.

Compiled dispatch (``cuda_graphs``, the counterpart of the reference's
``jax.jit(make_train_step(...))`` in ``launch/train.py``): on the card the
whole step (forward, backward through K3 / K5, clip, AdamW) is one CUDA
graph (``serving.graphs``). Its first call runs the step eagerly on the
capture's side stream (that call's result), then captures it over static
batch tensors and the caller's params and optimizer state, which the step
updates in place; each later call copies the batch in and replays. A call
with other param or state tensors than those captured over (a restored
checkpoint) drops the graph and captures anew, as jit retraces on new
buffers; a batch of another shape or dtype takes a graph of its own.
Under ``remat_policy="dots"`` the products each checkpoint keeps live from
the forward to the backward inside that one graph, so its pool holds them
as well.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build
from repro_torch.serving import graphs
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten, leaves, unflatten


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


class TrainStep:
    """``train_step(params, state, batch) -> (params, state, metrics)``:
    metrics are ``loss`` and the model's (``ce``, ``moe_aux``, ``moe_z``)
    and ``grad_norm``, 0-d tensors; params and state are updated in place
    and returned.

    ``cuda_graphs`` None runs the step as a CUDA graph where the params lie
    on the card and eagerly elsewhere (the CPU, ``meta``); False is the
    eager step (``jax.disable_jit()``'s counterpart); True raises off the
    card. It is resolved at the first call. On the graph route the metrics
    are the graph's static tensors, which the next call overwrites: read
    them before it. ``graphs`` (a ``serving.graphs.StepGraphs``) may be set
    before the first call to run the graph route with another ``capture``
    (``graphs.capture_eager`` on the CPU); ``graph_stats()`` reports it."""

    def __init__(self, cfg: ModelConfig,
                 ocfg: opt.AdamWConfig = opt.AdamWConfig(),
                 cuda_graphs: Optional[bool] = None):
        self.grad_fn = value_and_grad(build(cfg).loss)
        self.ocfg = ocfg
        self.cuda_graphs = cuda_graphs
        self.graphs: Optional[graphs.StepGraphs] = None
        # the (address, shape, dtype) of every param and state leaf the
        # graphs were captured over
        self._bound: tuple = ()

    def eager(self, params, state: opt.AdamWState, batch: Dict[str, Any]
              ) -> Tuple[Any, opt.AdamWState, Dict[str, torch.Tensor]]:
        """The step, run operator by operator."""
        (loss, metrics), grads = self.grad_fn(params, batch)
        params, state, om = opt.update(grads, state, params, self.ocfg)
        return params, state, dict(metrics, loss=loss, **om)

    def _resolve(self, params) -> bool:
        if self.graphs is not None:
            return True
        dev = leaves(params)[0].device
        if self.cuda_graphs is None:
            self.cuda_graphs = dev.type == "cuda"
        elif self.cuda_graphs and dev.type != "cuda":
            raise ValueError("cuda_graphs=True needs params on a CUDA "
                             f"device, not {dev}")
        if self.cuda_graphs:
            self.graphs = graphs.StepGraphs(dev)
        return bool(self.cuda_graphs)

    def __call__(self, params, state: opt.AdamWState, batch: Dict[str, Any]
                 ) -> Tuple[Any, opt.AdamWState, Dict[str, torch.Tensor]]:
        if not self._resolve(params):
            return self.eager(params, state, batch)
        bound = tuple((t.data_ptr(), t.shape, t.dtype)
                      for t in leaves((params, state)))
        if bound != self._bound:
            self.graphs.clear()
            self._bound = bound
        key = ("train",) + tuple((k, tuple(v.shape), v.dtype)
                                 for k, v in sorted(batch.items()))
        metrics = self.graphs.run(
            key, lambda **b: self.eager(params, state, b)[2], dict(batch))
        return params, state, dict(metrics)

    def graph_stats(self) -> Dict:
        """``cuda_graphs``, and on the graph route the captures, replays,
        capture seconds and graph-pool bytes (``StepGraphs.stats``)."""
        out = {"cuda_graphs": self.graphs is not None}
        if self.graphs is not None:
            out.update(self.graphs.stats())
        return out


def make_train_step(cfg: ModelConfig,
                    ocfg: opt.AdamWConfig = opt.AdamWConfig(),
                    cuda_graphs: Optional[bool] = None) -> TrainStep:
    """-> train_step(params, state, batch) -> (params, state, metrics), a
    ``TrainStep``: one CUDA graph on the card unless ``cuda_graphs`` is
    False."""
    return TrainStep(cfg, ocfg, cuda_graphs)


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
