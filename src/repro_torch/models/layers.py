"""Core layers of the serving path: RMS norm, rotary embeddings, attention,
MLPs.

Plain functions on tensors, computing what ``repro.models.layers`` computes:

  * ``rms_norm`` works in float32 and scales by ``(1 + w)``;
  * ``apply_rope`` is half-split partial rotary, with cos/sin cast to x's
    dtype before the multiply;
  * ``simple_attention`` is the masked reference attention, and
    ``attention`` the dispatch that sends full-sequence attention on the
    card to the flash kernel (K3);
  * ``apply_mlp`` uses the tanh GELU, which is ``jax.nn.gelu``'s default;
  * ``cross_entropy_loss`` is the training loss: log-sum-exp in float32,
    then the label's logit picked out.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import runs_kernels
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.gqa import group_heads, ungroup_heads


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope_tables(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., rot_dim//2), f32."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (b, s, h, d); cos/sin: (b, s, rot//2) or (s, rot//2)."""
    if rotary_pct <= 0.0:
        return x
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    # insert the head axis so (.., s, 1, r2) broadcasts against (b, s, h, r2)
    cos = cos.unsqueeze(-2).to(x.dtype)
    sin = sin.unsqueeze(-2).to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def simple_attention(q, k, v, *, causal: bool, kv_len=None, q_offset=0,
                     scale: Optional[float] = None, window: int = 0,
                     pairing: str = "kv_major"):
    """Reference attention. q: (b, sq, hq, d), k: (b, skv, hkv, d),
    v: (b, skv, hkv, dv) — dv may differ from d.

    kv_len: optional int or (b,) tensor — keys at positions >= kv_len are
    masked; q_offset: the position of query 0 (int or 0-d tensor); window:
    sliding window (0 = full); pairing: which kv head q-head h reads, see
    ``repro_torch.kernels.gqa``. Scores and softmax in float32 (the
    reference's two operand precisions give one result, since bf16
    products are exact in f32); ``p`` is cast to v's dtype before ``p.V``,
    as the reference does."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = group_heads(q, k.shape[2], pairing)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    dev = q.device
    kpos = torch.arange(skv, device=dev)
    qpos = torch.as_tensor(q_offset, device=dev) + torch.arange(sq,
                                                                device=dev)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None, None, None]              # (1, 1, 1, sq, skv)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        if kv_len.ndim == 0:                   # uniform cache length
            mask = mask & (kpos < kv_len)
        else:                                  # per-slot lengths (b,)
            mask = mask & (kpos[None, :] < kv_len[:, None])[
                :, None, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return ungroup_heads(o, pairing)


def attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
              window: int = 0, scale: Optional[float] = None,
              gqa_mode: str = "grouped"):
    """Dispatch: on the card (and on ``meta``), full-sequence attention (no ``kv_len``, no
    window, queries from position 0) goes to the flash kernel (K3) at every
    sq; everything else, and every CPU tensor, to ``simple_attention``.
    ``gqa_mode="tiled"`` is the reference's tiled KV, which pairs q-head h
    with kv head h % hkv; the kernel reads that head in place instead of
    tiling."""
    pairing = "g_major" if gqa_mode == "tiled" else "kv_major"
    from_zero = not torch.is_tensor(q_offset) and q_offset == 0
    if runs_kernels(q.device) and kv_len is None and not window \
            and from_zero:
        return fa.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, scale=scale,
                                  pairing=pairing)
    return simple_attention(q, k, v, causal=causal, kv_len=kv_len,
                            q_offset=q_offset, window=window, scale=scale,
                            pairing=pairing)


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu_mlp":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
        return h @ params["w_down"]
    if act == "gelu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh")
    else:
        h = F.silu(x @ params["w_gate"])
    return (h * (x @ params["w_up"])) @ params["w_down"]


def _init(shape, generator: torch.Generator, device, scale=None,
          dtype=torch.float32) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), as the reference's ``_init``
    (different random numbers: the generator is torch's)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_mlp(d_model: int, d_ff: int, act: str, *, generator, device,
             dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    if act == "gelu_mlp":
        return {"w_up": _init((d_model, d_ff), **kw),
                "w_down": _init((d_ff, d_model), **kw)}
    return {"w_gate": _init((d_model, d_ff), **kw),
            "w_up": _init((d_model, d_ff), **kw),
            "w_down": _init((d_ff, d_model), **kw)}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V), taken in float32; labels int (...); mask optional
    {0, 1} (...). The mean negative log-likelihood (over the mask's ones
    where given, at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
