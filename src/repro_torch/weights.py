"""Weight bridge: the reference's parameter pytree -> the port's params.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` with every leaf already converted to a numpy array (the
caller does ``jax.tree.map(np.asarray, params)``; this module imports no
JAX). Its layer params are stacked on a leading L axis; the port keeps a
list of per-layer dicts. Floats are cast to ``cfg.compute_dtype`` ONCE,
here, which is what the reference's per-call ``cast_floats`` computes every
step. A numpy leaf whose dtype is named ``bfloat16`` (ml_dtypes) crosses as
its raw bits (``uint16`` -> ``torch.int16`` view -> bf16), so no ml_dtypes
import is needed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype


def numpy_to_torch(arr) -> torch.Tensor:
    """A host numpy array as a CPU tensor. ``bfloat16`` arrays (from
    ml_dtypes) and ``uint16`` arrays are taken as bf16 bit patterns — the
    layout the port's own bf16 pool pages use on the host."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name in ("bfloat16", "uint16"):
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``numpy_to_torch``: a bf16 tensor returns its raw bits as
    ``np.uint16``; other dtypes convert as numpy does."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def slot_payload_as(payload: Dict, bf16) -> Dict:
    """An ``extract_slot`` payload ({"k", "v"} numpy arrays) with every
    16-bit float leaf viewed as ``bf16``, bit for bit. ``np.uint16`` carries
    a JAX ``InferenceEngine`` payload (ml_dtypes bfloat16) into the port's
    layout; the caller's ml_dtypes ``bfloat16`` carries a port payload to
    the JAX engine's ``restore_slot``. Float32 leaves pass unchanged."""
    out = {}
    for name, arr in payload.items():
        arr = np.asarray(arr)
        if arr.dtype.name in ("bfloat16", "uint16"):
            arr = arr.view(bf16)
        out[name] = arr
    return out


def prepare_params(raw: Dict, cfg: ModelConfig, device) -> Dict:
    """Cast raw params (any dtype/device, layers as a list of dicts) to the
    compute dtype on ``device``. Adds ``unembed``: the (d, V) output
    projection in float32, because the reference unembeds in f32 from the
    compute-dtype weights (``transformer._unembed``) — for tied embeddings
    that is ``embed`` rounded to the compute dtype and widened again."""
    dev = resolve_device(device)
    ct = torch_dtype(cfg.compute_dtype)

    def cast(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dev)
        return x.to(ct) if x.is_floating_point() else x

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return cast(x)

    out = {"embed": cast(raw["embed"]), "final_norm": cast(raw["final_norm"]),
           "layers": [tree(lp) for lp in raw["layers"]]}
    if cfg.tie_embeddings:
        out["unembed"] = out["embed"].float().t()
    else:
        out["unembed"] = cast(raw["lm_head"]).float()
    return out


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device="cuda") -> Dict:
    """The reference's ``init_params`` pytree (numpy leaves) as the port's
    params on ``device``."""
    device = resolve_device(device)     # fail before converting anything

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return numpy_to_torch(x)

    layers = conv(np_tree["layers"])
    n = cfg.n_layers

    def pick(x, i):
        if isinstance(x, dict):
            return {k: pick(v, i) for k, v in x.items()}
        return x[i]

    raw = {"embed": conv(np_tree["embed"]),
           "final_norm": conv(np_tree["final_norm"]),
           "layers": [pick(layers, i) for i in range(n)]}
    if "lm_head" in np_tree:
        raw["lm_head"] = conv(np_tree["lm_head"])
    return prepare_params(raw, cfg, device)
