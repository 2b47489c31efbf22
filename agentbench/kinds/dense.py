"""The dense kind: a decoder-only GQA transformer whose every layer is the
same, attention over every cached key and one MLP (plain GELU or SwiGLU).

The work counts are the benchmark's own arithmetic, frozen here so that a
change to the program cannot change what its steps are held against.
Model FLOPs count the products a token needs (two per multiply-add): the
projections and the MLP of every layer, the attention scores and the
weighted sum over the keys it sees, and the output projection for each
token that is sampled. Padding slots, norms, rotary and softmax are not
counted. Bytes count what one attention launch has to move at least: each
query and output once and every live key and value of every row once.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from agentbench.reference.model import dims
from agentbench.weights import NORM_SCALE
from repro_torch.configs.base import ModelConfig

REFERENCE = "model"
ACTS = {"gelu_tanh": "gelu_mlp", "swiglu": "silu"}
PAIRINGS = {"g_major": "tiled", "kv_major": "grouped"}

Leaves = Dict[str, Tuple[Tuple[int, ...], float]]


def port_config(cfg: Dict) -> ModelConfig:
    """The program's ``ModelConfig`` for a configuration file."""
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        act=ACTS[cfg["mlp"]], rope_theta=float(cfg["rope_theta"]),
        rotary_pct=float(cfg["partial_rotary_factor"]),
        norm_eps=float(cfg["norm_eps"]),
        # the program's tied path also scales the embedding by sqrt(d), as
        # Gemma does and neither model here; a tied model's output
        # projection comes in as ``lm_head``, the embedding's transpose
        tie_embeddings=False,
        compute_dtype=cfg["torch_dtype"],
        kv_cache_dtype=cfg.get("kv_cache_dtype", ""),
        gqa_mode=PAIRINGS[cfg["kv_head_pairing"]])


def layer_leaves(m: Dict) -> Leaves:
    """name -> (one layer's shape, scale). Matrices are scaled by
    ``1 / sqrt(fan_in)``, norm scales are small draws around 0 (the norm
    multiplies by ``1 + w``)."""
    d, hq, hkv, hd, ff = m["d"], m["hq"], m["hkv"], m["hd"], m["ff"]
    out = {"attn_norm": ((d,), NORM_SCALE), "mlp_norm": ((d,), NORM_SCALE),
           "attn.wq": ((d, hq * hd), d ** -0.5),
           "attn.wk": ((d, hkv * hd), d ** -0.5),
           "attn.wv": ((d, hkv * hd), d ** -0.5),
           "attn.wo": ((hq * hd, d), (hq * hd) ** -0.5),
           "mlp.w_up": ((d, ff), d ** -0.5),
           "mlp.w_down": ((ff, d), ff ** -0.5)}
    if m["mlp"] == "swiglu":
        out["mlp.w_gate"] = ((d, ff), d ** -0.5)
    return out


def layer_groups(m: Dict) -> List[Tuple[List[int], Leaves]]:
    """Every layer alike: one group of all L layers."""
    return [(list(range(m["L"])), layer_leaves(m))]


def n_params(m: Dict) -> int:
    per_layer = sum(len(idx) * sum(math.prod(s) for s, _ in leaves.values())
                    for idx, leaves in layer_groups(m))
    heads = 1 if m["tied"] else 2
    return per_layer + heads * m["V"] * m["d"] + m["d"]


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


def max_context(conf: Dict, engine_max_len: int) -> int:
    """The program's paged attention has no window, so a session stops at
    the configuration's ``sliding_window``, where it has one: up to there
    full attention is the window's."""
    return min(engine_max_len, int(conf.get("sliding_window") or 1 << 62))
