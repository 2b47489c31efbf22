"""Plain PyTorch version of flash attention (forward).

Computes what ``repro.kernels.flash_attention.ref.attention_ref`` computes:
q (b, sq, hq, d) against k (b, skv, hkv, d) and v (b, skv, hkv, dv), causal
from position 0 on both sides, softmax in float32, output in q's dtype,
with a ``pairing`` argument the reference leaves at "kv_major". The
wrapper in ``ops`` takes this path for CPU tensors; on the card it is what
the CUDA kernel is held against."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gqa import group_heads, ungroup_heads


def attention_ref(q, k, v, *, causal: bool = True, scale=None,
                  pairing: str = "kv_major"):
    """q: (b, sq, hq, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv);
    hq % hkv == 0. ``pairing`` as in ``repro_torch.kernels.gqa``. Returns
    (b, sq, hq, dv) in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qg = group_heads(q, k.shape[2], pairing)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ungroup_heads(o, pairing).to(q.dtype)
