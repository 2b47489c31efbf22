"""The raw weights of a run, drawn from the seed on the device.

One ``torch.Generator`` on the device, one ``randn`` call per kind of leaf
with every layer's copy stacked on a leading axis, in the dtype the model
is served in. Matrices are scaled by ``1 / sqrt(fan_in)`` (the embedding
by 0.02), norm scales are small draws around 0 (the norm multiplies by
``1 + w``). A tied model draws no output projection: its ``lm_head`` is
the embedding's transpose, a view of the same tensor, and its embedding is
drawn at the output projection's scale, ``1 / sqrt(d)``, so that its
logits spread as an untied model's do. The per-layer leaves are views of the stacked tensors, laid
out as the program's ``prepare_params`` takes them; the reference reads
the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORM_SCALE = 0.1


def layer_leaves(m: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """name -> (one layer's shape, scale) for ``reference.model.dims``."""
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


def n_params(m: Dict) -> int:
    per_layer = sum(math.prod(s) for s, _ in layer_leaves(m).values())
    heads = 1 if m["tied"] else 2
    return m["L"] * per_layer + heads * m["V"] * m["d"] + m["d"]


def _draw(gen, shape, scale, device, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x.mul_(scale)


def draw(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """{"embed", "final_norm", "lm_head", "layers": [per-layer dicts]}."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    embed = m["d"] ** -0.5 if m["tied"] else 0.02
    raw = {"embed": _draw(gen, (m["V"], m["d"]), embed, device, dtype),
           "final_norm": _draw(gen, (m["d"],), NORM_SCALE, device, dtype)}
    raw["lm_head"] = (raw["embed"].t() if m["tied"] else
                      _draw(gen, (m["d"], m["V"]), m["d"] ** -0.5, device,
                            dtype))
    layers: List[Dict] = [{"attn": {}, "mlp": {}} for _ in range(m["L"])]
    for name, (shape, scale) in layer_leaves(m).items():
        stacked = _draw(gen, (m["L"], *shape), scale, device, dtype)
        for li, lay in enumerate(layers):
            if "." in name:
                group, leaf = name.split(".")
                lay[group][leaf] = stacked[li]
            else:
                lay[name] = stacked[li]
    raw["layers"] = layers
    return raw
