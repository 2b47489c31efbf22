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


BLOCK_M = 64    # query rows (positions x heads of one kv head) per tile


def key_tile(d: int, dv: int) -> int:
    """Keys per tile of K3's bf16 kernel: 64, or 32 where d or dv padded to
    16 exceeds 128 (registers)."""
    return 32 if max(-(-d // 16), -(-dv // 16)) * 16 > 128 else 64


def attention_tiled_ref(q, k, v, *, causal: bool = True, scale=None,
                        pairing: str = "kv_major", p_dtype=None):
    """K3's tensor-core walk in plain PyTorch, in float32: the rows of each
    (b, kv head), query positions x the g q-heads of that kv head, cut into
    M tiles of BLOCK_M; each M tile walks key tiles of ``key_tile(d, dv)``
    keys up to the one holding its last position's
    diagonal when causal, with an online softmax (running max and sum in
    float32, scores scaled in log2 units as the kernel does). P is rounded
    to ``p_dtype`` (None: not rounded) before P.V; the sum takes P
    unrounded. Arguments and result as ``attention_ref``."""
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    block_n = key_tile(d, dv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    rows = sq * g
    # (b, hkv, sq * g, d): row r is position r // g, head r % g of the group
    qr = group_heads(q, hkv, pairing).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d).float()
    kf = k.permute(0, 2, 1, 3).float()                 # (b, hkv, skv, d)
    vf = v.permute(0, 2, 1, 3).float()
    out = torch.empty((b, hkv, rows, dv), device=q.device)
    for r0 in range(0, rows, BLOCK_M):
        r1 = min(r0 + BLOCK_M, rows)
        qpos = torch.arange(r0, r1, device=q.device) // g
        kv_hi = min(skv, (r1 - 1) // g + 1) if causal else skv
        m = torch.full((b, hkv, r1 - r0), float("-inf"), device=q.device)
        l = torch.zeros((b, hkv, r1 - r0), device=q.device)
        acc = torch.zeros((b, hkv, r1 - r0, dv), device=q.device)
        for k0 in range(0, kv_hi, block_n):
            k1 = min(k0 + block_n, skv)
            s = qr[:, :, r0:r1] @ kf[:, :, k0:k1].transpose(-1, -2)
            s = s * scale_log2
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s,
                                float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(torch.isinf(m_new), 0., m_new)
            corr = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * corr + p.sum(-1)
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * corr[..., None] + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    o = out.reshape(b, hkv, sq, g, dv).permute(0, 2, 1, 3, 4)
    return ungroup_heads(o, pairing).to(q.dtype)
