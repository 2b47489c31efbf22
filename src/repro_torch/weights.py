"""Weight bridge: the reference's parameter pytree -> the port's params.

Two forms of params. Serving takes the prepared dict (``prepare_params``,
``params_from_jax``): compute dtype, layers as lists, ``unembed`` in place
of ``lm_head``. Training keeps the master tree (``train_params_from_jax``,
``stack_layers``): the reference's own layout, float32 leaves with the
layers stacked on leading axes, which the optimizer moments and the
checkpoint mirror leaf for leaf. ``forward_params`` turns a master tree
into prepared params differentiably, so autograd carries every gradient
back to the stacked leaves.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` (or ``repro.models.hybrid.init_params``) with every leaf
already converted to a numpy array (the caller does
``jax.tree.map(np.asarray, params)``; this module imports no JAX). Its
layer params are stacked on leading axes; the port keeps lists of
per-layer dicts. Floats are cast to ``cfg.compute_dtype`` ONCE,
here, which is what the reference's per-call ``cast_floats`` computes every
step. A numpy leaf whose dtype is named ``bfloat16`` (ml_dtypes) crosses as
its raw bits (``uint16`` -> ``torch.int16`` view -> bf16), and one named
``float8_e4m3fn`` (an fp8 KV cache's pages) as ``uint8`` bits, so no
ml_dtypes import is needed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import FP8, cast_to, resolve_device, torch_dtype


def numpy_to_torch(arr) -> torch.Tensor:
    """A host numpy array as a CPU tensor. ``bfloat16`` arrays (from
    ml_dtypes) and ``uint16`` arrays are taken as bf16 bit patterns — the
    layout the port's own bf16 pool pages use on the host — and ml_dtypes
    ``float8_e4m3fn`` arrays as fp8 bit patterns. A bare ``uint8`` array
    stays ``uint8``: it may hold fp8 bits or bytes, which only its reader
    knows (``host_as``)."""
    arr = np.asarray(arr)         # a 0-d array stays 0-d; copies are C order
    if arr.dtype.name in ("bfloat16", "uint16"):
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(FP8)
    return torch.from_numpy(arr.copy())


def host_as(arr, dtype: torch.dtype) -> torch.Tensor:
    """A host array (or a tensor) bound for a tensor of ``dtype``, as a
    tensor of it on the same device: ``uint8`` bits viewed as float8 where
    ``dtype`` is float8_e4m3fn, bit patterns as ``numpy_to_torch`` reads
    them, any other values cast as the reference's ``asarray(x, dtype)``
    casts (``device.cast_to``). The pool and the dense engine read host
    pages by their own dtype this way, so fp8 bits are never converted as
    numbers."""
    t = arr if torch.is_tensor(arr) else numpy_to_torch(arr)
    if dtype == FP8 and t.dtype == torch.uint8:
        return t.view(FP8)
    return cast_to(t, dtype)


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``numpy_to_torch``: a bf16 tensor returns its raw bits as
    ``np.uint16``, a float8_e4m3fn one as ``np.uint8``; other dtypes
    convert as numpy does."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == FP8:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def slot_payload_as(payload: Dict, bf16, f8=None) -> Dict:
    """An ``extract_slot`` payload ({"k", "v"} numpy arrays) with every
    16-bit float leaf viewed as ``bf16`` and, where ``f8`` is given, every
    8-bit leaf as ``f8``, bit for bit. ``np.uint16`` / ``np.uint8`` carry a
    JAX ``InferenceEngine`` payload (ml_dtypes bfloat16 / float8_e4m3fn)
    into the port's layout; the caller's ml_dtypes types carry a port
    payload to the JAX engine's ``restore_slot``. Float32 leaves pass
    unchanged."""
    out = {}
    for name, arr in payload.items():
        arr = np.asarray(arr)
        if arr.dtype.name in ("bfloat16", "uint16"):
            arr = arr.view(bf16)
        elif f8 is not None and arr.dtype.name in ("float8_e4m3fn",
                                                   "uint8"):
            arr = arr.view(f8)
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


STACKED = {"layers": 1, "enc_layers": 1, "groups": 2, "tail": 1}


def _unbind(x, depth: int):
    """Inverse of ``_stack`` as views: a pytree of stacked leaves -> nested
    lists of per-layer pytrees. Each leaf is cut once by ``torch.unbind``,
    so its gradient is gathered in one stack, not summed from one full-size
    tensor per layer."""
    if depth == 0:
        return x

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return torch.unbind(t, 0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    parts = cut(x)
    leaf = parts
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_unbind(pick(parts, i), depth - 1) for i in range(len(leaf))]


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device="cuda") -> Dict:
    """The reference's ``init_params`` pytree (numpy leaves) as the port's
    params on ``device``: ``layers`` stacked (L, ...) becomes a list of L
    dicts, and so does the encoder's ``enc_layers``; the hybrid's
    ``groups`` stacked (G, E, ...) a list of G lists of E dicts and its
    ``tail`` (T, ...) a list of T dicts; ``shared``, ``dense0`` (an MoE
    stack's unstacked leading layer) and the rest stay as they are. The MoE
    router is rounded to the compute dtype like every float, and the
    router widens it to f32 for its product, which is what the reference's
    ``cast_floats`` and then ``.astype(f32)`` compute."""
    device = resolve_device(device)     # fail before converting anything

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return numpy_to_torch(x)

    raw = {k: _unbind(conv(v), STACKED.get(k, 0))
           for k, v in np_tree.items()}
    return prepare_params(raw, cfg, device)


def train_params_from_jax(np_tree: Dict, device="cuda") -> Dict:
    """The reference's ``init_params`` pytree (numpy leaves) as a master
    tree for training: the same nested dicts, each leaf a tensor of the
    same dtype (the reference's ``param_dtype``, float32) on ``device``,
    layers still stacked on their leading axes."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return numpy_to_torch(x).to(device)

    return conv(np_tree)


def _stack(x, depth: int):
    """Nested lists (``depth`` deep) of per-layer pytrees -> one pytree
    whose leaves are stacked on ``depth`` leading axes."""
    if depth == 0:
        return x
    items = [_stack(v, depth - 1) for v in x]

    def join(ts):
        if isinstance(ts[0], dict):
            return {k: join([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)

    return join(items)


def stack_layers(raw: Dict) -> Dict:
    """Raw params with per-layer lists (``layers``, ``enc_layers``,
    ``tail``; the hybrid's ``groups`` a list of lists) -> the reference's
    stacked layout; the other entries are kept as they are."""
    return {k: _stack(v, STACKED.get(k, 0)) for k, v in raw.items()}


def forward_params(master: Dict, cfg: ModelConfig) -> Dict:
    """A master tree (the reference's layout) as the prepared params the
    model functions take, differentiably: each layer's slice of the stacked
    leaves as a view, every float cast to the compute dtype, and
    ``unembed`` = ``embed`` rounded to the compute dtype and widened to
    float32, transposed, for tied embeddings (else ``lm_head`` so rounded),
    as ``prepare_params`` computes it."""
    ct = torch_dtype(cfg.compute_dtype)

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x.to(ct) if x.is_floating_point() else x

    out = {k: cast(_unbind(v, STACKED.get(k, 0)))
           for k, v in master.items() if k != "lm_head"}
    out["unembed"] = (out["embed"].float().t() if cfg.tie_embeddings
                      else master["lm_head"].to(ct).float())
    return out
