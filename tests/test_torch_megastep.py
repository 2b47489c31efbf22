"""The port's ``mixed_step_paged`` against the reference's on the CPU at
float32: gemma-2b smoke (MQA, hq4/hkv1) and chatglm3-6b smoke (GQA,
hq4/hkv2, partial rotary, untied head), rows inactive / decode / partial /
full at C in {1, 8, 16, 32}. The sampled ids must be equal and the pools
within 1e-5 (block 0, where padding and inactive rows all write, is left
out). Also: the poison mask turns exactly its own row into -1; the flat
route (``flat`` below B * C: the dense layers on the real tokens end to
end) holds to the same reference at C = 32, and ``flat == B * C`` is the
padded step bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttr
from repro_torch.weights import params_from_jax

BLK, NPAGES, B = 8, 8, 4
_jit_step = jax.jit(jtr.mixed_step_paged, static_argnames=("cfg",))


@pytest.fixture(scope="module", params=["gemma-2b", "chatglm3-6b"])
def models(request):
    arch = request.param
    jcfg = jax_smoke(arch).replace(remat=False, compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(remat=False,
                                          compute_dtype="float32")
    params = build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


def _inputs(cfg, C, seed):
    rng = np.random.default_rng(seed)
    nb = B * NPAGES + 1
    shape = (cfg.n_layers, nb, BLK, cfg.n_kv_heads, cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    # inactive, decode, partial, full
    valids = np.array([0, 1, max(1, C // 2), C], np.int32)
    lens = np.array([0, 13, 9, NPAGES * BLK - C], np.int32)
    tables = rng.permutation(np.arange(1, nb))[: B * NPAGES].reshape(
        B, NPAGES).astype(np.int32)
    return k, v, toks, lens, valids, tables


def _run_both(models, C, seed, poison=None, flat=None):
    jcfg, params, tcfg, tp = models
    k, v, toks, lens, valids, tables = _inputs(jcfg, C, seed)
    jpoison = None if poison is None else jnp.asarray(poison)
    jids, jpools = _jit_step(params, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                             jnp.asarray(toks), jnp.asarray(lens),
                             jnp.asarray(valids), jnp.asarray(tables),
                             cfg=jcfg, poison_mask=jpoison)
    tpools = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    tpoison = None if poison is None else torch.from_numpy(poison)
    tids = ttr.mixed_step_paged(tp, tpools, torch.from_numpy(toks),
                                torch.from_numpy(lens),
                                torch.from_numpy(valids),
                                torch.from_numpy(tables), tcfg, tpoison,
                                flat=flat)
    return np.asarray(jids), jpools, tids.numpy(), tpools


@pytest.mark.parametrize("C", [1, 8, 16, 32])
def test_mixed_step_matches_reference(models, C):
    jids, jpools, tids, tpools = _run_both(models, C, seed=C)
    assert tids.dtype == np.int32
    np.testing.assert_array_equal(tids[1:], jids[1:])   # row 0 is inactive
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:, 1:],
                                   np.asarray(jpools[name])[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def test_poison_mask_fails_only_its_row(models):
    poison = np.array([False, False, True, False])
    jids, _, tids, _ = _run_both(models, 16, seed=5, poison=poison)
    _, _, clean, _ = _run_both(models, 16, seed=5)
    assert tids[2] == -1 and jids[2] == -1
    np.testing.assert_array_equal(tids[[1, 3]], clean[[1, 3]])
    np.testing.assert_array_equal(tids[[1, 3]], jids[[1, 3]])


@pytest.mark.parametrize("width", ["real", "half"])
def test_flat_step_matches_reference(models, width, monkeypatch):
    """C = 32, the rows' 49 real tokens on N = 49 flat slots (no spare) or
    on N = B * C / 2 = 64: the reference's padded step's ids and pools."""
    C = 32
    valids = _inputs(models[0], C, seed=C)[4]
    n = int(valids.sum()) if width == "real" else B * C // 2
    maps = []
    real = ttr.attn_mod.flat_slots
    monkeypatch.setattr(ttr.attn_mod, "flat_slots",
                        lambda *a: maps.append(a[-1]) or real(*a))
    jids, jpools, tids, tpools = _run_both(models, C, seed=C, flat=n)
    assert maps == [n]
    np.testing.assert_array_equal(tids[1:], jids[1:])   # row 0 is inactive
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:, 1:],
                                   np.asarray(jpools[name])[:, 1:],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [1, 32])
def test_full_flat_width_is_the_padded_step(models, C):
    """``flat == B * C`` (every decode step, every bucket at or below the
    budget) runs the padded step: ids and pools, null block included, bit
    for bit."""
    _, _, want, want_pools = _run_both(models, C, seed=C)
    _, _, got, got_pools = _run_both(models, C, seed=C, flat=B * C)
    np.testing.assert_array_equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(got_pools[name], want_pools[name])
