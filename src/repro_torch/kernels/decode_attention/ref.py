"""Plain PyTorch version of decode attention: one query per (b, q-head)
against a contiguous KV cache with a valid length per row.

Computes what ``repro.kernels.decode_attention.ref.decode_attention_ref``
computes, in the layout the port's kernel reads: the cache in the model's
(b, S, hkv, d) layout rather than the reference's (b, hkv, S, d), and the
length a scalar or a (b,) vector. The wrapper in ``ops`` takes this path
for CPU tensors; on the card it is what the CUDA kernel is held against.
Masked keys get -inf, as in the reference, so a row needs a length >= 1."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gqa import group_heads, ungroup_heads


def decode_attention_ref(q, k, v, kv_len, *, scale=None,
                         pairing: str = "kv_major"):
    """q: (b, hq, d); k: (b, S, hkv, d); v: (b, S, hkv, dv); kv_len: an int
    or a (b,) integer tensor, row b seeing keys ``< kv_len[b]``.
    ``pairing`` as in ``repro_torch.kernels.gqa``. Returns (b, hq, dv) in
    q's dtype; the math runs in float32."""
    b, S, hkv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qg = group_heads(q[:, None], hkv, pairing)       # (b, 1, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    lens = torch.as_tensor(kv_len, device=q.device).long().reshape(-1)
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ungroup_heads(o, pairing)[:, 0].to(q.dtype)
