"""Mamba-2 block (SSD, state-space duality): the port of
``repro.models.ssd``.

``ssd_chunked`` is the chunked scan every layer's full-sequence pass runs:
kernel K5 on the card, its plain version on the CPU. The rest is plain
PyTorch, as the reference leaves it to XLA: ``ssd_decode_step`` (the O(1)
recurrent update at decode), the depthwise ``causal_conv``, and the block
itself, ``mamba_full`` (in_proj -> causal conv -> SSD -> gated norm ->
out_proj) and ``mamba_decode``.

Shapes: x (b, s, h, p); dt (b, s, h) float32 after softplus; A (h,)
negative; B, C (b, s, g, n) with h % g == 0. State: (b, g, h/g, n, p)
float32; conv state: the last K-1 pre-conv inputs (b, K-1, conv_dim).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import _init, rms_norm


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Returns (y (b, s, h, p) in x's dtype, final state (b, g, h/g, n, p)
    float32); raises ``ValueError`` unless ``min(chunk, s)`` divides s."""
    return ssd_ops.ssd(x, dt, A, B, C, chunk, initial_state)


def ssd_decode_step(x, dt, A, B, C, state):
    """One recurrent step. x (b, h, p); dt (b, h) float32; B, C (b, g, n);
    state (b, g, h/g, n, p) float32. Returns (y (b, h, p) in x's dtype,
    the new state)."""
    b, h, p = x.shape
    g = B.shape[1]
    hg = h // g
    f32 = torch.float32
    xg = x.reshape(b, g, hg, p).to(f32)
    dtg = dt.reshape(b, g, hg).to(f32)
    dec = torch.exp(dtg * A.reshape(g, hg).to(f32))
    upd = torch.einsum("bgn,bgk,bgkp->bgknp", B.to(f32), dtg, xg)
    state = state * dec[..., None, None] + upd
    y = torch.einsum("bgn,bgknp->bgkp", C.to(f32), state)
    return y.reshape(b, h, p).to(x.dtype), state


# ------------------------------------------------ the full Mamba-2 block

def _dims(cfg: ModelConfig):
    m: SSMConfig = cfg.ssm
    d_in = m.expand * cfg.d_model
    h = d_in // m.head_dim
    conv_dim = d_in + 2 * m.n_groups * m.d_state
    return m, d_in, h, conv_dim


def init_mamba(cfg: ModelConfig, *, generator, device, dtype=torch.float32):
    """The reference's init distribution (torch's random numbers)."""
    m, d_in, h, conv_dim = _dims(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    in_dim = 2 * d_in + 2 * m.n_groups * m.d_state + h
    f32 = dict(device=device, dtype=torch.float32)
    return {
        "in_proj": _init((cfg.d_model, in_dim), **kw),
        "conv_w": _init((m.conv_kernel, conv_dim), scale=0.5, **kw),
        "conv_b": torch.zeros((conv_dim,), device=device, dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)).to(dtype),
        "D": torch.ones((h,), device=device, dtype=dtype),
        # the inverse softplus of the initial dt
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, h, **f32))).to(dtype),
        "norm": torch.zeros((d_in,), device=device, dtype=dtype),
        "out_proj": _init((d_in, cfg.d_model), **kw),
    }


def causal_conv(x, w, b):
    """Depthwise causal conv. x (b, s, c); w (K, c); b (c,). Written as K
    shifted multiply-adds summed in float32, rounded to x's dtype, then the
    bias added in x's dtype, as the reference's conv and ``+ b`` round. No
    cuDNN, whose float32 convolution on the card is TF32 by default."""
    K, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)).float()
    wf = w.to(x.dtype).float()
    acc = xp[:, 0:s] * wf[0]
    for k in range(1, K):
        acc = acc + xp[:, k:k + s] * wf[k]
    return acc.to(x.dtype) + b.to(x.dtype)


def _split_proj(params, xt, cfg: ModelConfig):
    m, d_in, h, conv_dim = _dims(cfg)
    proj = xt @ params["in_proj"]
    z, xbc, dt = torch.split(proj, [d_in, conv_dim, h], dim=-1)
    return z, xbc, dt, (m, d_in, h, conv_dim)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) without torch's linear cut-off
    above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gate_out(params, y, z, cfg: ModelConfig):
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def mamba_full(params, xt, cfg: ModelConfig, initial=None):
    """xt (b, s, d) -> (y (b, s, d), (conv_state, ssm_state)): the block
    over a whole sequence, with the decode state it hands over."""
    b, s, _ = xt.shape
    z, xbc, dt, (m, d_in, h, conv_dim) = _split_proj(params, xt, cfg)
    # conv state for the decode handoff: the last K-1 pre-conv inputs
    k = m.conv_kernel
    conv_state = (xbc[:, s - (k - 1):] if s >= k - 1
                  else F.pad(xbc, (0, 0, k - 1 - s, 0)))
    xbc = F.silu(causal_conv(xbc, params["conv_w"], params["conv_b"]))
    ng = m.n_groups * m.d_state
    x, B, C = torch.split(xbc, [d_in, ng, ng], dim=-1)
    # views of the conv output, strided along (b, s): K5 reads them in place
    x = x.unflatten(-1, (h, m.head_dim))
    B = B.unflatten(-1, (m.n_groups, m.d_state))
    C = C.unflatten(-1, (m.n_groups, m.d_state))
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, ssm_state = ssd_chunked(x, dt, A, B, C, m.chunk, initial)
    y = y + x * params["D"].to(x.dtype)[None, None, :, None]
    out = _gate_out(params, y.reshape(b, s, d_in), z, cfg)
    return out, (conv_state, ssm_state)


def mamba_decode(params, xt, state, cfg: ModelConfig):
    """xt (b, 1, d); state = (conv_state (b, K-1, conv_dim), ssm_state).
    Returns (y (b, 1, d), (new conv_state, new ssm_state)); the inputs are
    not modified."""
    conv_state, ssm_state = state
    b = xt.shape[0]
    z, xbc, dt, (m, d_in, h, conv_dim) = _split_proj(params, xt, cfg)
    window = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)
    wd = window.dtype
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].to(wd).float()).to(wd)
    xbc1 = F.silu(conv_out + params["conv_b"].to(wd))
    ng = m.n_groups * m.d_state
    x, B, C = torch.split(xbc1, [d_in, ng, ng], dim=-1)
    x = x.reshape(b, h, m.head_dim)
    B = B.reshape(b, m.n_groups, m.d_state)
    C = C.reshape(b, m.n_groups, m.d_state)
    dt = _softplus(dt[:, 0].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, ssm_state = ssd_decode_step(x, dt, A, B, C, ssm_state)
    y = y + x * params["D"].to(x.dtype)[None, :, None]
    out = _gate_out(params, y.reshape(b, 1, d_in), z, cfg)
    return out, (window[:, 1:], ssm_state)
