"""The raw weights of a run, drawn from the seed on the device.

One ``torch.Generator`` on the device, one ``randn`` call per leaf of each
of the kind's layer groups (``layer_groups``) with the group's layers
stacked on a leading axis, in the dtype the model is served in, each
scaled as the kind states. The embedding is scaled by 0.02 and the final
norm is a small draw around 0. A tied model draws no output projection:
its ``lm_head`` is the embedding's transpose, a view of the same tensor,
and its embedding is drawn at the output projection's scale,
``1 / sqrt(d)``, so that its logits spread as an untied model's do. The
per-layer leaves are views of the stacked tensors, laid out as the
program's ``prepare_params`` takes them; the reference reads the same
tensors.
"""
from __future__ import annotations

from typing import Dict, List

import torch

NORM_SCALE = 0.1


def _draw(gen, shape, scale, device, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x.mul_(scale)


def draw(m: Dict, groups: List, seed: int, device,
         dtype=torch.bfloat16) -> Dict:
    """{"embed", "final_norm", "lm_head", "layers": [per-layer dicts]};
    ``groups`` is the kind's ``layer_groups(m)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    embed = m["d"] ** -0.5 if m["tied"] else 0.02
    raw = {"embed": _draw(gen, (m["V"], m["d"]), embed, device, dtype),
           "final_norm": _draw(gen, (m["d"],), NORM_SCALE, device, dtype)}
    raw["lm_head"] = (raw["embed"].t() if m["tied"] else
                      _draw(gen, (m["d"], m["V"]), m["d"] ** -0.5, device,
                            dtype))
    layers: List[Dict] = [{} for _ in range(m["L"])]
    for idx, leaves in groups:
        for name, (shape, scale) in leaves.items():
            stacked = _draw(gen, (len(idx), *shape), scale, device, dtype)
            *path, leaf = name.split(".")
            for j, li in enumerate(idx):
                lay = layers[li]
                for key in path:
                    lay = lay.setdefault(key, {})
                lay[leaf] = stacked[j]
    raw["layers"] = layers
    return raw
