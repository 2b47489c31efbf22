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


def decode_attention_split_ref(q, k, v, kv_len, *, split: int, scale=None,
                               pairing: str = "kv_major"):
    """K4's split-K walk in plain PyTorch, in float32: the S keys cut into
    ranges of ``split`` (``ops.split_plan`` gives the kernel's), one partial
    (m, l, o) per (row, q-head, range) over the range's keys below the row's
    length (m = -inf, l = 0 where it has none), then the non-empty partials
    merged in range order. Arguments and result as
    ``decode_attention_ref``; a row of length 0 gives zeros (the
    denominator is floored at 1e-30)."""
    b, S, hkv, _ = k.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n_split = -(-S // split)
    pad = n_split * split - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(b, n_split, split, hkv, -1)
    vf = vf.reshape(b, n_split, split, hkv, dv)
    qg = group_heads(q[:, None], hkv, pairing)[:, 0].float()  # (b, hkv, g, d)
    s = torch.einsum("bhgd,bnthd->bhgnt", qg, kf) * scale
    lens = torch.as_tensor(kv_len, device=q.device).long().reshape(-1)
    lens = torch.clamp(lens.expand(b), 0, S)
    kpos = torch.arange(n_split * split, device=q.device).reshape(n_split,
                                                                  split)
    seen = (kpos[None] < lens[:, None, None])[:, None, None]  # (b,1,1,n,t)
    s = torch.where(seen, s, float("-inf"))
    m = s.amax(-1)                  # (b, hkv, g, n): -inf for an empty range
    p = torch.exp(s - torch.where(torch.isinf(m), 0., m)[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgnt,bnthd->bhgnd", p, vf)
    # merge in range order; an empty range has weight exp(-inf) = 0
    M = m.amax(-1)
    w = torch.exp(m - torch.where(torch.isinf(M), 0., M)[..., None])
    L = (w * l).sum(-1)
    out = (w[..., None] * o).sum(-2) / torch.clamp(L, min=1e-30)[..., None]
    return ungroup_heads(out[:, None], pairing)[:, 0].to(q.dtype)
