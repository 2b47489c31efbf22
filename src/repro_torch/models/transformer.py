"""Decoder-only LM: the dense GQA, MoE, MLA, VLM and Mamba-2 SSM families,
the port of ``repro.models.transformer``, run eagerly.

  * ``forward`` — logits over a full sequence (teacher forcing);
  * ``init_decode_state`` / ``prefill`` / ``decode_step`` — the contiguous
    KV cache of the lockstep decode and the dense slot engine;
  * ``init_paged_pools`` / ``decode_step_paged`` / ``prefill_chunk_paged``
    — the legacy paged loop;
  * ``mixed_step_paged`` — the megastep: one call advances the whole mixed
    batch one engine iteration, its dense layers on the padded batch or on
    a flat token axis of the real tokens (``flat``).

Each layer is attention (GQA, or MLA where ``cfg.mla`` is set) then an MLP,
or a routed MoE where ``cfg.moe`` is set (``models.moe``: every token of
the call is routed, padding columns included, so which tokens a full
expert drops depends on the whole batch, as in the reference). An MoE
stack with ``first_dense_layers`` (deepseek-v2-lite) keeps that leading
dense layer apart as ``dense0``, with its own MLA caches ``ckv0`` /
``krope0``; the rest are ``layers``. The VLM family (llava) prepends
``patch_embeds`` to the text in ``forward`` and ``prefill`` and drops the
image positions from the logits; its paged members are text only. An MLA
caches the latent (c_kv, k_rope) and decodes at a scalar length; it has no
paged members, as in the reference.

The SSM family (``family == "ssm"``, mamba2-370m) runs ``forward``,
``init_decode_state``, ``prefill`` and ``decode_step``: a stack of Mamba-2
blocks (``models.ssd``, kernel K5 in every full-sequence layer) whose
decode state is a conv window and an SSD state per layer. The paged
members are the GQA family's alone, as in the reference.

Params are the prepared dict of ``repro_torch.weights`` (compute dtype,
layers as a list). Caches and pools are device tensors updated in place,
where the reference returns new donated buffers; the functions return only
their logits or ids. ``forward`` returns logits alone.

Training: ``loss(params, batch, cfg)`` takes the master tree
(``Model.init_train_params``, or ``weights.train_params_from_jax``:
float32, the reference's stacked layout), prepares it differentiably
(``weights.forward_params``) and returns ``(total, {"ce", "moe_aux",
"moe_z"})``: cross-entropy over the text positions plus the MoE aux and z
losses summed over the layers, at the reference's weights 0.01 and 1e-3.
With ``cfg.remat`` each scanned layer runs under ``torch.utils.checkpoint``,
as the reference's ``remat_wrap`` places it (an MoE stack's ``dense0``
runs outside it, as there). ``cfg.remat_policy`` "full" recomputes the
whole layer in the backward; any other value is "dots", the reference's
``dots_with_no_batch_dims_saveable``: the outputs of the layer's plain
matrix products that its backward reads are kept from the forward, and
everything else (the batched products, the norms, the kernels) is
recomputed.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, Optional, Sequence

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (FP8, bits, cast_to, resolve_device,
                                seeded_generator, torch_dtype)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (_init, apply_mlp, cross_entropy_loss,
                                       init_mlp, rms_norm)
from repro_torch.weights import forward_params, prepare_params


def _check_supported(cfg: ModelConfig):
    if cfg.family not in ("dense", "moe", "vlm", "ssm") \
            or cfg.is_encoder_decoder or cfg.first_dense_layers > 1:
        raise NotImplementedError(
            f"{cfg.name}: this module serves the decoder-only families "
            "(dense, MoE, MLA, VLM, SSM; at most one leading dense layer); "
            "the hybrid is models.hybrid, the encoder-decoder models.encdec")


def check_gqa_family(cfg: ModelConfig):
    """The paged pools and both serving engines hold attention K/V: the
    reference admits the decoder-only GQA families there (dense, MoE, VLM)
    and no MLA or encoder-decoder."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: paged KV pools and the serving engines target the "
            f"decoder-only GQA family, not {cfg.family!r} (as in the "
            "reference); serve it through decode_step")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the reference's engines refuse the "
            "encoder-decoder (they assert family in dense/moe/vlm, "
            "serving/engine.py:42, serving/paging/engine.py:158); serve it "
            "through models.encdec's init_cross_cache and decode_step")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: the reference serves no MLA engine: its paged "
            "pools assert mla is None (models/transformer.py:285), and its "
            "InferenceEngine admits MLA but fails at the first decode step, "
            "mla_decode taking a scalar cache_len (models/attention.py:389) "
            "under per-slot lengths; serve it through prefill and "
            "decode_step at a scalar cache_len")
    _check_supported(cfg)


def refuse_fp8(cfg: ModelConfig, what: str) -> str:
    """The message of the ``ValueError`` that refuses an fp8 KV cache where
    the reference fails on one: its first decode step mixes the fp8 cache
    with compute-dtype values and raises ``TypePromotionError``."""
    return (f"{cfg.name}: kv_cache_dtype={cfg.kv_cache_dtype!r} is not "
            f"served for {what}: the reference stores it in that dtype and "
            "its first decode step fails (TypePromotionError, the cache "
            f"against {cfg.compute_dtype}); use kv_cache_dtype='' (the "
            "compute dtype)")


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, seed: int = 0, device="cuda") -> Dict:
    """Random params drawn on ``device`` with a seeded torch generator (the
    reference's init distribution, torch's random numbers), prepared as
    ``weights.prepare_params`` does."""
    _check_supported(cfg)
    dev = resolve_device(device)
    raw = _raw_params(cfg, generator, seed, dev,
                      torch_dtype(cfg.compute_dtype))
    return prepare_params(raw, cfg, dev)


def _raw_params(cfg: ModelConfig, generator, seed: int, dev, dtype) -> Dict:
    """Every leaf drawn in ``dtype``, per-layer params as lists."""
    if generator is None:
        generator = seeded_generator(dev, seed)
    kw = dict(generator=generator, device=dev, dtype=dtype)
    zeros = dict(device=dev, dtype=dtype)
    raw = {"embed": _init((cfg.vocab_size, cfg.d_model), scale=0.02, **kw),
           "final_norm": torch.zeros((cfg.d_model,), **zeros)}
    if cfg.family == "ssm":
        raw["layers"] = [{"norm": torch.zeros((cfg.d_model,), **zeros),
                          "mamba": ssd_mod.init_mamba(cfg, **kw)}
                         for _ in range(cfg.n_layers)]
    else:
        n_scan = cfg.n_layers - cfg.first_dense_layers
        raw["layers"] = [_init_layer(cfg, kw) for _ in range(n_scan)]
        if cfg.first_dense_layers:
            raw["dense0"] = _init_layer(cfg, kw,
                                        dense_ff=cfg.first_dense_d_ff)
    if not cfg.tie_embeddings:
        raw["lm_head"] = _init((cfg.d_model, cfg.vocab_size), **kw)
    return raw


def _init_layer(cfg: ModelConfig, kw: dict, dense_ff: int = 0) -> Dict:
    """One transformer layer; ``dense_ff`` > 0 forces a dense MLP of that
    width (deepseek-v2-lite's layer 0)."""
    zeros = dict(device=kw["device"], dtype=kw["dtype"])
    p = {"attn_norm": torch.zeros((cfg.d_model,), **zeros),
         "mlp_norm": torch.zeros((cfg.d_model,), **zeros),
         "attn": (attn_mod.init_mla(cfg, **kw) if cfg.mla is not None
                  else attn_mod.init_gqa(cfg, **kw))}
    if dense_ff or cfg.moe is None:
        p["mlp"] = init_mlp(cfg.d_model, dense_ff or cfg.d_ff, cfg.act, **kw)
    else:
        p["moe"] = moe_mod.init_moe(cfg, **kw)
    return p


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """(L, num_blocks, blk, hkv, hd) K and V pools. Zero-filled, never
    ``torch.empty``: masked positions still enter p.V with p == 0, and a
    NaN in the null block or a stale slot would turn that into NaN."""
    check_gqa_family(cfg)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=ct, device=dev),
            "v": torch.zeros(shape, dtype=ct, device=dev)}


def _embed(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        # the scale is rounded to the compute dtype first, as the reference
        # multiplies by jnp.asarray(d ** 0.5, x.dtype); a 0-d host tensor
        # enters the product as a scalar, so no copy to the card is made,
        # which a CUDA graph capture could not hold
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _assemble_input(params, tokens, cfg: ModelConfig, patch_embeds):
    """The text embeddings, behind the image's patch embeddings for a VLM
    (b, n_image_tokens, d), as the reference's ``_assemble_input``."""
    x = _embed(params, tokens, cfg)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: a VLM's forward and prefill take "
                             "patch_embeds (b, n_image_tokens, d_model)")
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _unembed(params, h):
    return h.float() @ params["unembed"]


def _mlp_aux(lp, x, cfg: ModelConfig):
    """The layer's MLP, or its routed MoE: (out, aux loss, z-loss), the
    losses float32 0-d tensors, None for a dense MLP."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if "moe" in lp:
        return moe_mod.apply_moe(lp["moe"], h, cfg)
    return apply_mlp(lp["mlp"], h, cfg.act), None, None


def _mlp(lp, x, cfg: ModelConfig):
    """The layer's MLP, or its routed MoE (aux losses dropped: decode)."""
    return _mlp_aux(lp, x, cfg)[0]


aten = torch.ops.aten
# The products "dots" keeps: the plain matrix products, which ``x @ w`` and
# ``F.linear`` dispatch to. A batched product (``aten.bmm``: the einsums of
# the plain attention, the SSD scan and the MoE dispatch and experts) has
# batch dims and is recomputed, as under the reference's policy; so is
# every kernel launch, which the dispatcher never sees.
DOTS = frozenset({aten.mm.default, aten.addmm.default})
# ops whose backward reads no tensor (views aside, which read none either;
# ``_unsafe_view``, the view ``x @ w`` ends in, is not marked as one)
_SAVES_NOTHING = frozenset({aten.add.Tensor, aten.sub.Tensor,
                            aten.neg.default, aten.cat.default,
                            aten.clone.default, aten._to_copy.default,
                            aten.detach.default, aten._unsafe_view.default})


@functools.cache
def _saves_nothing(func) -> bool:
    return func in _SAVES_NOTHING or any(
        r.alias_info is not None for r in func._schema.returns)


def _may_save(func, args, kwargs) -> bool:
    """Whether autograd may save a tensor for ``func``'s backward: grad
    mode is on, an input requires grad, and ``func`` is no view and not
    one of ``_SAVES_NOTHING``."""
    if _saves_nothing(func) or not torch.is_grad_enabled():
        return False
    for a in (*args, *kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


class _KeepDots(TorchDispatchMode):
    """The forward of a "dots" region: keeps each plain product's output
    (detached; beside it a weak reference to the output and its version,
    since an alias made under a dispatch mode does not share the output's
    version counter, and a strong one would tie the output's graph into a
    cycle through the checkpoint). At the region's end it drops the
    products made after the last op that may save a tensor for autograd:
    the recompute stops at that op, so no backward reads them, and the
    reference keeps a product only where its backward reads it (a layer's
    last product, which feeds only the residual sum, is not kept)."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept
        self.read = 0       # the products before the last saving op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _may_save(func, args, kwargs):
            # autograd saves an op's inputs before it runs
            self.read = len(self.kept)
        out = func(*args, **kwargs)
        if func in DOTS:
            self.kept.append((out.detach(), weakref.ref(out), out._version))
        return out

    def __exit__(self, *exc):
        del self.kept[self.read:]
        return super().__exit__(*exc)


def _dot_shape(func, args) -> tuple:
    a, b = args[-2:]        # mm(a, b), addmm(bias, a, b)
    return (a.shape[0], b.shape[1])


class _ReplayDots(TorchDispatchMode):
    """The recompute of a "dots" region: the i-th plain product returns the
    i-th kept output (once) instead of running; every other op runs. A
    kept output changed in place since the forward, or one of another
    shape than the product asks, raises: the recompute must run the
    forward's ops in the forward's order."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept
        self.at = 0

    def __enter__(self):
        self.at = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in DOTS:
            i, self.at = self.at, self.at + 1
            if i < len(self.kept) and self.kept[i] is not None:
                out, ref, version = self.kept[i]
                self.kept[i] = None
                # a dead output has no view left that could have changed it
                now = version if ref() is None else ref()._version
                if now != version \
                        or tuple(out.shape) != _dot_shape(func, args):
                    raise RuntimeError(
                        f"remat_policy='dots': product {i} of the region "
                        f"was kept at {tuple(out.shape)} (version "
                        f"{version}); the recompute asks for "
                        f"{_dot_shape(func, args)} and finds version {now}")
                return out
        return func(*args, **(kwargs or {}))


def _dots_contexts():
    """``context_fn`` of a "dots" checkpoint: the forward's mode and the
    recompute's, over one list of kept products."""
    kept: list = []
    return _KeepDots(kept), _ReplayDots(kept)


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` where ``cfg.remat`` is set
    and a gradient is being recorded, else ``fn`` itself.
    ``cfg.remat_policy`` "full" drops every activation of ``fn`` and
    recomputes it in the backward. Any other value means "dots", as in the
    reference (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``):
    the outputs of the plain matrix products (``DOTS``) that the backward
    reads are kept from the forward, and the recompute runs everything
    else. Checkpoints nest: each level keeps its own."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kw = {} if cfg.remat_policy == "full" else {"context_fn": _dots_contexts}
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, preserve_rng_state=False,
                             **kw)


# ------------------------------------------------------------ full forward

def _layer_full(x, lp, cfg: ModelConfig, return_kv=False):
    """One layer over the sequence: (x, (aux, z)), and with ``return_kv``
    also its cache entries: the rotated (k, v), or MLA's (c_kv,
    k_rope)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    full = attn_mod.mla_full if cfg.mla is not None else attn_mod.gqa_full
    a, kv = (full(lp["attn"], h, cfg, return_kv=True) if return_kv
             else (full(lp["attn"], h, cfg), None))
    x = x + a
    m, aux, z = _mlp_aux(lp, x, cfg)
    return x + m, (aux, z), kv


def _mamba_full(lp, x, cfg: ModelConfig):
    """One SSM layer over the sequence: (x + block(norm(x)), its decode
    state)."""
    y, st = ssd_mod.mamba_full(lp["mamba"],
                               rms_norm(x, lp["norm"], cfg.norm_eps), cfg)
    return x + y, st


def _stack(params):
    """The attention layers in order: ``dense0`` (where there is one), then
    ``layers``."""
    return ([params["dense0"]] if "dense0" in params else []) \
        + params["layers"]


def _forward(params, tokens, cfg: ModelConfig, patch_embeds=None):
    """-> (logits (b, s_text, V) float32, MoE aux loss, z-loss), the two
    summed over the layers; each of ``layers`` under ``remat_wrap``, and
    ``dense0`` outside it, as the reference scans and remats ``layers``
    alone."""
    x = _assemble_input(params, tokens, cfg, patch_embeds)
    aux = z = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        mamba = remat_wrap(lambda lp, h: _mamba_full(lp, h, cfg)[0], cfg)
        for lp in params["layers"]:
            x = mamba(lp, x)
    else:
        def body(lp, h):
            return _layer_full(h, lp, cfg)[:2]
        layer = remat_wrap(body, cfg)
        calls = [(body, params["dense0"])] if "dense0" in params else []
        for fn, lp in calls + [(layer, lp) for lp in params["layers"]]:
            x, (a, zz) = fn(lp, x)
            if a is not None:
                aux, z = aux + a, z + zz
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, cfg.n_image_tokens:]
    return _unembed(params, x), aux, z


def forward(params, tokens, cfg: ModelConfig, *, patch_embeds=None):
    """tokens: (b, s) int -> logits (b, s, V) float32, every text
    position. A VLM takes ``patch_embeds`` (b, n_image_tokens, d) ahead of
    the text. An SSM's s must be at most its chunk or a multiple of it."""
    return _forward(params, tokens, cfg, patch_embeds)[0]


def loss(params, batch: Dict, cfg: ModelConfig):
    """params: the master tree (float32, stacked layers); batch: ``tokens``
    and ``labels`` (b, s_text) int, a VLM's ``patch_embeds``. Returns
    (total, {"ce", "moe_aux", "moe_z"}), 0-d float32 tensors:
    total = ce + 0.01 moe_aux + 1e-3 moe_z."""
    logits, aux, z = _forward(forward_params(params, cfg), batch["tokens"],
                              cfg, batch.get("patch_embeds"))
    ce = cross_entropy_loss(logits, batch["labels"])
    total = ce + 0.01 * aux + 1e-3 * z
    return total, {"moe_aux": aux, "moe_z": z, "ce": ce}


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed contiguous KV cache in the KV cache dtype: ``k``/``v`` of
    shape (L, batch, max_len, hkv, hd). An MLA caches its latent instead:
    ``ckv`` (L, batch, max_len, rank) and ``krope`` (L, batch, max_len,
    rope) over ``layers``, and ``ckv0``/``krope0`` (batch, max_len, ...)
    for ``dense0``. For the SSM family (no KV, ``max_len`` unused):
    ``conv`` (L, batch, K-1, conv_dim) in the cache dtype and ``ssm``
    (L, batch, g, h/g, n, p) float32."""
    _check_supported(cfg)
    ct = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
    if ct == FP8 and (cfg.family == "ssm" or cfg.mla is not None):
        raise ValueError(refuse_fp8(cfg, "an MLA's latent cache"
                                    if cfg.mla is not None
                                    else "the SSM's conv state"))
    dev = resolve_device(device)

    def zeros(*shape, dtype=ct):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "ssm":
        m, _, h, conv_dim = ssd_mod._dims(cfg)
        return {"conv": zeros(cfg.n_layers, batch, m.conv_kernel - 1,
                              conv_dim),
                "ssm": zeros(cfg.n_layers, batch, m.n_groups,
                             h // m.n_groups, m.d_state, m.head_dim,
                             dtype=torch.float32)}
    n_scan = cfg.n_layers - cfg.first_dense_layers
    if cfg.mla is not None:
        r, rd = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
        st = {"ckv": zeros(n_scan, batch, max_len, r),
              "krope": zeros(n_scan, batch, max_len, rd)}
        if cfg.first_dense_layers:
            st.update(ckv0=zeros(batch, max_len, r),
                      krope0=zeros(batch, max_len, rd))
        return st
    shape = (n_scan, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def _fill(cache, new):
    """Write prefill entries (b, s, ...) into positions 0.. of one layer's
    cache, in place, cast by the reference's rule (``device.cast_to``)."""
    bits(cache)[:, :new.shape[1]] = bits(cast_to(new, cache.dtype))


def _layer_caches(state: Dict, cfg: ModelConfig, li: int):
    """The two caches of attention layer ``li`` of ``_stack``, as views of
    ``state``."""
    if cfg.mla is None:
        return state["k"][li], state["v"][li]
    if cfg.first_dense_layers:
        if li == 0:
            return state["ckv0"], state["krope0"]
        li -= 1
    return state["ckv"][li], state["krope"][li]


def prefill(params, tokens, cfg: ModelConfig, *, state: Dict,
            patch_embeds=None):
    """Full-sequence prefill. tokens: (b, s) -> the last position's logits
    (b, 1, V) float32; each layer's cache entries are written into
    positions [0, s) of ``state`` (the dict of ``init_decode_state``, or
    views of one), in place. A VLM's ``patch_embeds`` go ahead of the text
    and fill the first n_image_tokens positions. An SSM writes each
    layer's ``conv`` window and final ``ssm`` state instead; its s must be
    at most its chunk or a multiple of it."""
    x = _assemble_input(params, tokens, cfg, patch_embeds)
    if cfg.family == "ssm":
        for li, lp in enumerate(params["layers"]):
            x, (conv, ssm) = _mamba_full(lp, x, cfg)
            state["conv"][li] = conv
            state["ssm"][li] = ssm
    else:
        for li, lp in enumerate(_stack(params)):
            x, _, kv = _layer_full(x, lp, cfg, return_kv=True)
            for cache, new in zip(_layer_caches(state, cfg, li), kv):
                _fill(cache, new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x[:, -1:])


def _layer_decode(lp, x, caches, cache_len, cfg: ModelConfig):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    dec = attn_mod.mla_decode if cfg.mla is not None else attn_mod.gqa_decode
    x = x + dec(lp["attn"], h, *caches, cache_len, cfg)
    return x + _mlp(lp, x, cfg)


def _mamba_decode(lp, x, conv, ssm, cfg: ModelConfig):
    """One SSM layer at one token; ``conv`` and ``ssm`` (one layer's views
    of the decode state) are updated in place."""
    y, (new_conv, new_ssm) = ssd_mod.mamba_decode(
        lp["mamba"], rms_norm(x, lp["norm"], cfg.norm_eps), (conv, ssm), cfg)
    conv.copy_(new_conv)
    ssm.copy_(new_ssm)
    return x + y


def decode_step(params, state: Dict, token, cache_len, cfg: ModelConfig):
    """token (b, 1) -> logits (b, 1, V) float32; ``state`` is updated in
    place. cache_len: an int (every row at one depth: the lockstep decode)
    or a (b,) int32 tensor (per-slot depths; not for an MLA, whose decode
    takes a scalar as the reference's does); an SSM does not read it."""
    x = _embed(params, token, cfg)
    if cfg.family == "ssm":
        for li, lp in enumerate(params["layers"]):
            x = _mamba_decode(lp, x, state["conv"][li], state["ssm"][li], cfg)
    else:
        for li, lp in enumerate(_stack(params)):
            x = _layer_decode(lp, x, _layer_caches(state, cfg, li),
                              cache_len, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def decode_step_paged(params, pools: Dict, token, cache_len, page_tables,
                      cfg: ModelConfig):
    """Paged analogue of ``decode_step``: token (b, 1) int32, cache_len (b,)
    int32 lengths before this token, page_tables (b, npages) int32; pools
    written in place. Returns logits (b, 1, V) float32."""
    x = _embed(params, token, cfg)
    for li, lp in enumerate(params["layers"]):
        hh = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_decode_paged(
            lp["attn"], hh, pools["k"][li], pools["v"][li], page_tables,
            cache_len, cfg)
        x = x + _mlp(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


def prefill_chunk_paged(params, pools: Dict, tokens, cache_len, valid,
                        page_table, cfg: ModelConfig):
    """Chunked prefill of one sequence over the paged pools: tokens (1, C)
    int32, null-padded past ``valid``; cache_len and valid: (1,) int32
    device tensors or ints, the tokens resident before the chunk and the
    chunk's real tokens; page_table (npages,) int32. The chunk's K/V is
    written into the sequence's pages in place. Returns logits (1, C, V)
    float32 (the caller reads position ``valid - 1``). Nothing here reads
    the lengths on the host, so the legacy loop captures the call once per
    chunk width."""
    x = _embed(params, tokens, cfg)
    cache_len = attn_mod.row_lengths(cache_len, x.device)
    valid = attn_mod.row_lengths(valid, x.device)
    for li, lp in enumerate(params["layers"]):
        hh = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_mod.gqa_prefill_chunk_paged(
            lp["attn"], hh, pools["k"][li], pools["v"][li], page_table,
            cache_len, valid, cfg)
        x = x + _mlp(lp, x, cfg)
    return _unembed(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One tensor-parallel shard of the megastep (DESIGN.md §13): ``cfg``
    with the LOCAL head counts (``n_heads/tp``, ``n_kv_heads/tp``,
    ``head_dim`` pinned), ``params`` its tree (the attention slices of
    ``distributed.sharding.shard_serving_params``; every other leaf shared
    by the shards on one device) and ``pools`` its KV-head slice of the
    pools, on the shard's device."""
    cfg: ModelConfig
    params: Dict
    pools: Dict[str, torch.Tensor]


def dense_width(layers, B: int, C: int, flat: Optional[int]) -> int:
    """The token slots a megastep of (B, C) runs its dense layers on: the
    flat width ``flat`` where it is below B * C, else B * C (the padded
    batch). A stack with a routed-MoE layer keeps B * C: its experts'
    capacity counts every token of a group, the padding slots among them,
    as in the reference."""
    if flat is None or flat >= B * C or any("moe" in lp for lp in layers):
        return B * C
    return flat


def mixed_step_paged(params, pools: Dict, tokens, cache_lens, valids,
                     page_tables, cfg: ModelConfig, poison_mask=None, *,
                     shards: Optional[Sequence[Shard]] = None,
                     flat: Optional[int] = None):
    """tokens: (B, C) int32, row b carrying ``valids[b]`` real tokens
    (decode rows: the last sampled token at column 0); cache_lens/valids:
    (B,) int32; page_tables: (B, npages) int32, null-padded; pools: the
    (L, ...) K/V tensors, written in place. Greedy sampling is part of the
    step: only each row's last valid column is unembedded and argmaxed.
    Returns (B,) int32 next ids; a row whose logits are not finite (or is
    set in ``poison_mask``) returns -1.

    ``shards`` runs the tensor-parallel megastep (``params`` and ``pools``
    unused, pass None): per layer, each shard's attention over its own
    heads and pools gives the local ``o @ wo`` partial, and the partials
    are summed in shard order 0..tp-1 onto each distinct device, the
    reference's one ``psum`` per layer. Norms and the MLP or MoE run once
    per distinct device on the identical residual stream; the first
    device unembeds and samples. One shard is the single-device step
    exactly: its "sum" is no op at all.

    ``flat`` is a static width N (the engine's: its token budget's largest
    bucket) at least ``sum(valids)``. Where ``dense_width`` takes it, the
    embedding, norms, projections, residuals and MLP run on N flat slots
    holding the real tokens end to end (``attention.flat_slots``), K1
    still on the (B, C) batch; the partial sums are (N, d). Elsewhere the
    step is the padded one above, op for op. A row with no real token
    samples an unspecified id on either route."""
    if shards is None:
        shards = (Shard(cfg, params, pools),)
    devs = list(dict.fromkeys(s.pools["k"].device for s in shards))
    # each device's first shard carries the replicated leaves it reads
    lead = {dev: next(s.params for s in shards if s.pools["k"].device == dev)
            for dev in devs}
    ins = {dev: [t.to(dev) for t in (tokens, cache_lens, valids,
                                     page_tables)] for dev in devs}
    B, C = tokens.shape
    n = dense_width(lead[devs[0]]["layers"], B, C, flat)
    fl = {dev: (attn_mod.flat_slots(ins[dev][1], ins[dev][2], C, n)
                if n < B * C else None) for dev in devs}
    x = {dev: _embed(lead[dev], ins[dev][0] if fl[dev] is None else
                     fl[dev].gather(ins[dev][0].reshape(-1))[None], cfg)
         for dev in devs}
    for li in range(len(lead[devs[0]]["layers"])):
        hh = {dev: rms_norm(x[dev], lead[dev]["layers"][li]["attn_norm"],
                            cfg.norm_eps) for dev in devs}
        parts = []
        for s in shards:
            dev = s.pools["k"].device
            _, lens, vals, tables = ins[dev]
            parts.append(attn_mod.gqa_mixed_step_paged(
                s.params["layers"][li]["attn"], hh[dev], s.pools["k"][li],
                s.pools["v"][li], tables, lens, vals, s.cfg, flat=fl[dev]))
        for dev in devs:
            a = parts[0].to(dev)
            if len(parts) > 1:
                with torch.profiler.record_function("tp.partial_sum"):
                    for part in parts[1:]:
                        a = a + part.to(dev)
            h = x[dev] + a
            x[dev] = h + _mlp(lead[dev]["layers"][li], h, cfg)
    dev = devs[0]
    p, vals = lead[dev], ins[dev][2]
    if fl[dev] is None:
        h = rms_norm(x[dev], p["final_norm"], cfg.norm_eps)
        rows = torch.arange(h.shape[0], device=dev)
        last = torch.clamp(vals.long() - 1, 0, h.shape[1] - 1)
        h = h[rows, last]
    else:
        h = rms_norm(x[dev][0, fl[dev].last], p["final_norm"], cfg.norm_eps)
    logits = _unembed(p, h)                           # (B, V) f32
    if poison_mask is not None:
        # poison lands after the K/V writes, so only this row's sampled
        # token is affected
        logits = torch.where(poison_mask.to(dev)[:, None],
                             torch.full_like(logits, float("nan")), logits)
    row_ok = torch.isfinite(logits).all(dim=-1)
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(row_ok, ids, torch.full_like(ids, -1))
