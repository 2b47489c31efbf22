"""The plain reference: a dense decoder-only GQA transformer in float32.

Written from a configuration file's keys alone (``agentbench/configs``),
with plain torch operations. It imports nothing of the program under test
and takes none of its state: it reads the raw weights the benchmark drew
(``agentbench.weights``) and the token ids the benchmark made, and works
out everything else itself.

Per layer: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``; a final norm
and the output projection (for a tied model the embedding's transpose, as
``agentbench.weights`` lays it out). Attention is causal and, where the file gives a
``sliding_window`` w, sees only the last w positions. The norm is RMS with a ``(1 + w)`` scale;
rotary is applied to the first ``partial_rotary_factor`` of each head's
dims, in two halves; query head ``h`` reads KV head ``h % hkv``
(``kv_head_pairing`` "g_major") or ``h // (hq // hkv)`` ("kv_major"); the
MLP is the tanh GELU of one product ("gelu_tanh") or SwiGLU ("swiglu").

``run`` computes one sequence layer by layer, each layer's weights widened
to float32 on the way in, attention in blocks of queries and the MLP in
blocks of rows, so that a sequence of 16k positions at 7B widths fits in a
few GB beside nothing else. TF32 is turned off for the process
(``exact_float32``). With ``fp8`` every operand of a product (weights,
activations, queries, keys, values) is first rounded to float8 e4m3 on a
per-tensor scale: the reference computed in the precision below bf16, the
check's control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Q_BLOCK = 512
ROW_BLOCK = 2048


def exact_float32() -> None:
    """Matrix products in float32 mean float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dims(cfg: Dict) -> Dict:
    """The sizes the reference reads from a configuration file."""
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} KV heads")
    return {"L": cfg["num_hidden_layers"], "d": cfg["hidden_size"],
            "hq": hq, "hkv": hkv, "hd": cfg["head_dim"],
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "mlp": cfg["mlp"], "theta": float(cfg["rope_theta"]),
            "rot": float(cfg["partial_rotary_factor"]),
            "eps": float(cfg["norm_eps"]),
            "pairing": cfg["kv_head_pairing"],
            "tied": bool(cfg["tie_word_embeddings"]),
            "window": int(cfg.get("sliding_window") or 0)}


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 on one scale for the tensor (its largest
    magnitude at e4m3's 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w)


def rotate(x: torch.Tensor, pos: torch.Tensor, frac: float,
           theta: float) -> torch.Tensor:
    """x (n, h, hd): the first ``frac`` of each head's dims rotated at
    positions ``pos`` (n,), as two halves (x1, x2) -> (x1 c - x2 s,
    x1 s + x2 c); the rest passes."""
    hd = x.shape[-1]
    rot = int(hd * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    ang = pos.float()[:, None] * inv                      # (n, rot/2)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, x[..., rot:]], -1)


def kv_index(hq: int, hkv: int, pairing: str, device) -> torch.Tensor:
    h = torch.arange(hq, device=device)
    if pairing == "g_major":
        return h % hkv
    if pairing == "kv_major":
        return h // (hq // hkv)
    raise ValueError(f"unknown kv_head_pairing {pairing!r}")


def mlp(w: Dict, h: torch.Tensor, kind: str, rnd=_same) -> torch.Tensor:
    out = torch.empty_like(h)
    for lo in range(0, h.shape[0], ROW_BLOCK):
        x = rnd(h[lo:lo + ROW_BLOCK])
        if kind == "gelu_tanh":
            a = F.gelu(x @ w["w_up"], approximate="tanh")
        elif kind == "swiglu":
            a = F.silu(x @ w["w_gate"]) * (x @ w["w_up"])
        else:
            raise ValueError(f"unknown mlp {kind!r}")
        out[lo:lo + ROW_BLOCK] = rnd(a) @ w["w_down"]
    return out


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_of: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q (n, hq, hd), k/v (n, hkv, hd) -> (n, hq * hd); position i sees
    keys 0..i, and with ``window`` only those after i - window. Softmax
    over float32 scores, in blocks of queries."""
    n, hq, hd = q.shape
    kk, vv = k[:, kv_of], v[:, kv_of]                     # (n, hq, hd)
    out = torch.empty((n, hq, hd), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    keys = torch.arange(n, device=q.device)
    for lo in range(0, n, Q_BLOCK):
        hi = min(n, lo + Q_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], kk[:hi]) * scale
        at = torch.arange(lo, hi, device=q.device)[:, None]
        mask = keys[None, :hi] > at
        if window:
            mask |= keys[None, :hi] <= at - window
        s.masked_fill_(mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  vv[:hi])
    return out.reshape(n, hq * hd)


def run(cfg: Dict, raw: Dict, tokens: torch.Tensor,
        logits_at: torch.Tensor,
        kv_sink: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                   None]] = None,
        fp8: bool = False) -> torch.Tensor:
    """One sequence through the model in float32 (operands rounded to e4m3
    with ``fp8``).

    tokens (n,) int on the weights' device; ``logits_at`` (m,) positions
    whose next-token logits are returned, (m, V) float32. ``kv_sink(layer,
    k, v)``, where given, receives each layer's rotated keys and values,
    (n, hkv, hd) float32 each."""
    rnd = e4m3 if fp8 else _same
    m = dims(cfg)
    dev = raw["embed"].device
    pos = torch.arange(tokens.shape[0], device=dev)
    kv_of = kv_index(m["hq"], m["hkv"], m["pairing"], dev)
    x = raw["embed"][tokens.long()].float()
    n = x.shape[0]
    for li, lay in enumerate(raw["layers"]):
        a = {k: rnd(t.float()) for k, t in lay["attn"].items()}
        h = rnd(rms_norm(x, lay["attn_norm"].float(), m["eps"]))
        q = rotate((h @ a["wq"]).reshape(n, m["hq"], m["hd"]), pos, m["rot"],
                   m["theta"])
        k = rotate((h @ a["wk"]).reshape(n, m["hkv"], m["hd"]), pos,
                   m["rot"], m["theta"])
        v = (h @ a["wv"]).reshape(n, m["hkv"], m["hd"])
        if kv_sink is not None:
            kv_sink(li, k, v)
        o = causal_attention(rnd(q), rnd(k), rnd(v), kv_of, m["window"])
        x = x + rnd(o) @ a["wo"]
        del a, h, q, k, v, o
        w = {k: rnd(t.float()) for k, t in lay["mlp"].items()}
        x = x + mlp(w, rms_norm(x, lay["mlp_norm"].float(), m["eps"]),
                    m["mlp"], rnd)
        del w
    h = rms_norm(x[logits_at.long()], raw["final_norm"].float(), m["eps"])
    return rnd(h) @ rnd(raw["lm_head"].float())
