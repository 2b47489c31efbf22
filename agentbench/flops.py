"""The benchmark's own arithmetic of model work, frozen here so that a change
to the program cannot change what its steps are held against.

Model FLOPs count the products a token needs (two per multiply-add): the
projections and the MLP of every layer, the attention scores and the
weighted sum over the keys it sees, and the output projection for each
token that is sampled. Padding slots, norms, rotary and softmax are not
counted. Bytes count what one attention launch has to move at least: each
query and output once and every live key and value of every row once.

Sizes come from ``reference.model.dims`` of a configuration file. The
device peaks are the data sheet's (NVIDIA H100 SXM, dense, no sparsity).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

# name as torch.cuda.get_device_name() gives it -> (bf16 FLOP/s, HBM B/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, HBM bytes/s) of a card, or None for one not listed."""
    return PEAKS.get(device_name)


def linear_flops_per_token(m: Dict) -> int:
    """The projections and the MLP of every layer, for one token."""
    d, hq, hkv, hd, ff = m["d"], m["hq"], m["hkv"], m["hd"], m["ff"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    mlp = (3 if m["mlp"] == "swiglu" else 2) * d * ff
    return 2 * m["L"] * (attn + mlp)


def attention_flops(m: Dict, ctx: int, t: int) -> int:
    """``t`` new tokens after ``ctx`` cached ones, causal: token i (0-based
    among the new) sees ctx + i + 1 keys; scores and the weighted sum are
    2 * hd FLOPs a key each, per query head and layer."""
    keys = t * ctx + t * (t + 1) // 2
    return 4 * m["L"] * m["hq"] * m["hd"] * keys


def unembed_flops(m: Dict) -> int:
    return 2 * m["d"] * m["V"]


def step_flops(m: Dict, rows: Iterable[Tuple[int, int, bool]]) -> int:
    """A step's model FLOPs: rows of (ctx before the step, tokens written,
    whether a token was sampled)."""
    lin = linear_flops_per_token(m)
    return sum(t * lin + attention_flops(m, ctx, t)
               + (unembed_flops(m) if sampled else 0)
               for ctx, t, sampled in rows)


def decode_attention_bytes(m: Dict, ctxs: Iterable[int],
                           kv_itemsize: int = 2, itemsize: int = 2) -> int:
    """Bytes one decode step's attention (C = 1) must move over all layers:
    per row the query and output (hq * hd each) and the ctx + 1 keys and
    values it reads (the new token's included)."""
    per_row_q = 2 * m["hq"] * m["hd"] * itemsize
    per_key = 2 * m["hkv"] * m["hd"] * kv_itemsize
    return m["L"] * sum(per_row_q + (c + 1) * per_key for c in ctxs)


def kv_bytes_per_token(m: Dict, kv_itemsize: int = 2) -> int:
    return 2 * m["L"] * m["hkv"] * m["hd"] * kv_itemsize
