"""Mixture-of-Experts: the router and the GShard grouped dispatch, the port
of ``repro.models.moe``.

``dispatch="einsum"`` (the default) is the one-hot formulation (GShard,
arXiv:2006.16668): tokens are cut into groups of ``GROUP``, and each group
dispatches into per-expert capacity ``ceil(GROUP * top_k * cf / E)`` slots,
priority by k and then by token order; a token past its expert's capacity
is dropped (its routed output is zero). ``dispatch="sort"`` is the
argsort/gather path with one capacity over all tokens and an overflow
scratch row. The experts, the router and the dispatch are plain products
(``torch.einsum``), as the reference's are XLA einsums outside any Pallas
kernel.

Routing is the reference's to the index: top-k by a stable descending
sort, so equal probabilities pick the lower expert first, as
``jax.lax.top_k`` does (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import _init, apply_mlp, init_mlp

GROUP = 256  # tokens per dispatch group


def init_moe(cfg: ModelConfig, *, generator, device, dtype=torch.float32):
    """The reference's ``_init`` rule as it stands: an (e, d, f) expert
    leaf's fan-in is its first axis, the expert count."""
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"router": _init((d, e), scale=0.02, **kw),
         "w_gate": _init((e, d, f), **kw),
         "w_up": _init((e, d, f), **kw),
         "w_down": _init((e, f, d), **kw)}
    if m.n_shared_experts:
        p["shared"] = init_mlp(d, f * m.n_shared_experts, cfg.act, **kw)
    return p


def _act(act: str):
    """The experts' activation: tanh GELU (``jax.nn.gelu``'s default) for
    ``gelu``, SiLU otherwise."""
    if act == "gelu":
        return lambda h: F.gelu(h, approximate="tanh")
    return F.silu


def _router(params, xf, m: MoEConfig):
    """xf: (T, d) -> gates (T, k) f32, idx (T, k) int64, Switch aux loss,
    router z-loss. The router weight, rounded to the compute dtype, is
    widened to f32 for the product, as the reference computes it."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce)
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    return gates, idx, aux, zloss


def _one_hot(idx, n: int, dtype):
    """One-hot over the last axis; an index outside [0, n) gives a zero row
    (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _capacity(tokens: int, m: MoEConfig) -> int:
    return int(max(1, -(-tokens * m.top_k * m.capacity_factor
                        // m.n_experts)))


def _experts(params, xe, act: str, spec: str):
    """The experts' gated MLP on per-expert inputs; ``spec`` is the batch
    prefix of ``xe`` ("gec" or "ec")."""
    h = torch.einsum(f"{spec}d,edf->{spec}f", xe, params["w_gate"])
    u = torch.einsum(f"{spec}d,edf->{spec}f", xe, params["w_up"])
    return torch.einsum(f"{spec}f,efd->{spec}d", _act(act)(h) * u,
                        params["w_down"])


def _dispatch_einsum(params, xf, gates, idx, m: MoEConfig, act: str):
    """GShard one-hot dispatch. xf: (T, d) -> (T', d), T' = T padded to a
    whole number of groups (padding routes to index E: dropped)."""
    t, d = xf.shape
    e = m.n_experts
    group = min(GROUP, t)
    if t % group:
        pad = group - t % group
        xf = F.pad(xf, (0, 0, 0, pad))
        gates = F.pad(gates, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad), value=e)
        t = xf.shape[0]
    g = t // group
    cap = _capacity(group, m)
    idx_g = idx.reshape(g, group, m.top_k)
    gates_g = gates.reshape(g, group, m.top_k)
    x_g = xf.reshape(g, group, d)

    # each (token, slot)'s place in its expert's queue: k first, then tokens
    # counted in int32, as the reference does (torch widens an integer
    # cumsum or sum to int64 unless told otherwise); the running count is
    # scanned along the last axis, because torch scans any other axis of a
    # CUDA tensor with one thread per column
    counts = torch.zeros((g, e), dtype=torch.int32, device=xf.device)
    disp = torch.zeros((g, group, e, cap), dtype=xf.dtype, device=xf.device)
    comb = torch.zeros_like(disp)
    for k in range(m.top_k):
        oh = _one_hot(idx_g[:, :, k], e, torch.int32)        # (g, grp, e)
        run = torch.cumsum(oh.transpose(1, 2), dim=-1, dtype=torch.int32)
        pos = run.transpose(1, 2) - 1 + counts[:, None, :]
        counts = counts + oh.sum(dim=1, dtype=torch.int32)
        keep = (pos < cap) & (oh > 0)
        pos_oh = _one_hot(pos, cap, xf.dtype) * keep[..., None].to(xf.dtype)
        disp = disp + pos_oh
        comb = comb + pos_oh * gates_g[:, :, k][..., None, None]

    expert_in = torch.einsum("gtec,gtd->gecd", disp, x_g)
    eo = _experts(params, expert_in, act, "gec")
    out = torch.einsum("gtec,gecd->gtd", comb, eo)
    return out.reshape(t, d)


def _dispatch_sort(params, xf, gates, idx, m: MoEConfig, act: str):
    """Argsort/gather dispatch: (token, slot) pairs sorted by expert into
    an (E * cap, d) buffer, one capacity over all T tokens; a pair past it
    goes to a scratch row and is dropped."""
    t, d = xf.shape
    e = m.n_experts
    cap = _capacity(t, m)
    dev = xf.device
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    tok_of = order // m.top_k
    srt_e = flat_e[order]
    start = torch.searchsorted(srt_e, torch.arange(e, device=dev))
    pos = torch.arange(t * m.top_k, device=dev) - start[srt_e]
    ok = pos < cap
    slot = torch.where(ok, srt_e * cap + pos, torch.full_like(pos, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[slot] = xf[tok_of]
    eo = _experts(params, buf[: e * cap].reshape(e, cap, d), act, "ec")
    eo = eo.reshape(e * cap, d)
    gathered = torch.where(ok[:, None], eo[torch.clamp(slot, max=e * cap - 1)],
                           torch.zeros((), dtype=eo.dtype, device=dev))
    flat_g = gates.reshape(-1)[order]
    out = torch.zeros((t, d), dtype=xf.dtype, device=dev)
    return out.index_add_(0, tok_of, gathered * flat_g[:, None].to(xf.dtype))


def apply_moe(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d), aux loss, z-loss). The tokens are
    routed and grouped in the order of ``x.reshape(b * s, d)``, so which
    ones a full group drops depends on every row of the call."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, idx, aux, zloss = _router(params, xf, m)
    gates = gates.to(x.dtype)
    if m.dispatch == "sort":
        out = _dispatch_sort(params, xf, gates, idx, m, cfg.act)
    else:
        out = _dispatch_einsum(params, xf, gates, idx, m, cfg.act)
    out = out[: b * s].reshape(b, s, d)
    if m.n_shared_experts:
        out = out + apply_mlp(params["shared"], x, cfg.act)
    return out, aux, zloss
