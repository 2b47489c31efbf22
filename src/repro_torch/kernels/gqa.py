"""Head pairing of grouped-query attention, shared by the plain versions of
the port's attention kernels and by ``models.layers.simple_attention``.

With g = hq // hkv, q-head h reads kv head h // g under "kv_major" (the
classic GQA layout, what the Pallas kernels index) or h % hkv under
"g_major" (the tiled-KV layout the reference's full paths run under
``gqa_mode="tiled"``)."""
from __future__ import annotations

import torch


def group_heads(q: torch.Tensor, hkv: int, pairing: str) -> torch.Tensor:
    """(b, s, hq, d) -> (b, s, hkv, g, d), the g q-heads of each kv head."""
    b, s, hq, d = q.shape
    g = hq // hkv
    if pairing == "g_major":
        return q.reshape(b, s, g, hkv, d).transpose(2, 3)
    if pairing != "kv_major":
        raise ValueError(f"pairing {pairing!r} not in ['g_major', "
                         "'kv_major']")
    return q.reshape(b, s, hkv, g, d)


def ungroup_heads(o: torch.Tensor, pairing: str) -> torch.Tensor:
    """Inverse of ``group_heads`` on a (b, s, hkv, g, dv) output."""
    if pairing == "g_major":
        o = o.transpose(2, 3)
    b, s = o.shape[:2]
    return o.reshape(b, s, -1, o.shape[-1])
