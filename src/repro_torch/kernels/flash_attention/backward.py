"""The gradient of flash attention (K3): the FlashAttention-2 backward
(Dao, arXiv:2307.08691, Algorithm 2) in torch ops, for
``ops.FlashAttentionFn``.

The reference has no backward kernel: it trains through XLA's autodiff of
its plain attention (``repro.models.layers.simple_attention``), whose
products run outside any Pallas kernel, so these may be ``torch.einsum``
(cuBLAS on the card) too. The forward kernel keeps each row's log-sum-exp,
so P is rebuilt as exp(scale q.k - lse) rather than by a second softmax:

    dV = P^T dO,   dP = dO V^T,   D = rowsum(dO * O),   dS = P * (dP - D),
    dQ = scale dS K,   dK = scale dS^T Q,

the g q-heads of each kv head summed into its dK and dV under either
``pairing``. Everything is float32; the gradients return in the inputs'
dtypes. dv may differ from d (MLA). Each call adds one to
``flash_attention_backward.calls``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gqa import group_heads, ungroup_heads


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool,
                             scale: float, pairing: str = "kv_major"):
    """q (b, sq, hq, d), k (b, skv, hkv, d), v (b, skv, hkv, dv), the
    forward's out and its gradient dout (b, sq, hq, dv), lse (b, hq, sq)
    float32. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    sq, skv, hkv = q.shape[1], k.shape[1], k.shape[2]
    qg = group_heads(q, hkv, pairing).float()          # (b, sq, hkv, g, d)
    og = group_heads(out, hkv, pairing).float()        # (b, sq, hkv, g, dv)
    dog = group_heads(dout, hkv, pairing).float()
    # (b, hq, sq) -> (b, hkv, g, sq) in the same pairing
    lse_g = group_heads(lse.transpose(1, 2)[..., None], hkv,
                        pairing)[..., 0].permute(0, 2, 3, 1)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - lse_g[..., None])                # (b, hkv, g, sq, skv)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    rows = (dog * og).sum(-1).permute(0, 2, 3, 1)      # D: (b, hkv, g, sq)
    ds = p * (dp - rows[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    flash_attention_backward.calls += 1
    return (ungroup_heads(dq, pairing).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


flash_attention_backward.calls = 0
