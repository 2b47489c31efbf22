"""Weight bridge: the reference's parameter pytree -> the port's params.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` (or ``repro.models.hybrid.init_params``) with every leaf
already converted to a numpy array (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX). Its
layer params are stacked on leading axes; the port keeps lists of
per-layer dicts. Floats are cast to ``cfg.compute_dtype`` ONCE,
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
    """Cast raw params (any dtype/device; per-layer params as lists of
    dicts, the hybrid's groups as a list of lists) to the compute dtype on
    ``device``. ``lm_head`` is replaced by ``unembed``: the (d, V) output
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
        if isinstance(x, list):
            return [tree(v) for v in x]
        return cast(x)

    out = {k: tree(v) for k, v in raw.items() if k != "lm_head"}
    if cfg.tie_embeddings:
        out["unembed"] = out["embed"].float().t()
    else:
        out["unembed"] = cast(raw["lm_head"]).float()
    return out


def _unstack(x, depth: int = 1):
    """A pytree whose leaves share ``depth`` leading stacked axes (the
    reference's scanned layers) as nested lists of per-layer pytrees."""
    if depth == 0:
        return x
    leaf = x
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    return [_unstack(pick(x, i), depth - 1) for i in range(leaf.shape[0])]


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device="cuda") -> Dict:
    """The reference's ``init_params`` pytree (numpy leaves) as the port's
    params on ``device``: ``layers`` stacked (L, ...) becomes a list of L
    dicts; the hybrid's ``groups`` stacked (G, E, ...) a list of G lists of
    E dicts and its ``tail`` (T, ...) a list of T dicts; ``shared`` and the
    rest stay as they are."""
    device = resolve_device(device)     # fail before converting anything

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return numpy_to_torch(x)

    depth = {"layers": 1, "groups": 2, "tail": 1}
    raw = {k: _unstack(conv(v), depth.get(k, 0)) for k, v in np_tree.items()}
    return prepare_params(raw, cfg, device)
