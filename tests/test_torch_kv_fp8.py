"""The fp8 KV cache (``kv_cache_dtype="float8_e4m3fn"``) of the PyTorch port
against the reference on the CPU.

  * ``device.cast_to`` casts as ``jnp.astype(float8_e4m3fn)`` does, bit for
    bit (NaN taken as equal), on every bf16 bit pattern and on f32 values
    at e4m3's boundaries: |x| > 464, +-inf and NaN become NaN, where
    torch's own ``.to`` saturates to +-448;
  * the plain versions of K1, K2 and K4 (what the wrappers run on CPU
    tensors) on fp8 pools and caches against the reference's Pallas
    kernels in interpret mode, at f32 and bf16 q, within the tolerances of
    tests/test_torch_paged_attention.py and
    tests/test_torch_attention_kernels.py;
  * at f32 compute, gemma-2b smoke (MQA) and chatglm3-6b smoke (GQA, hkv
    2): ``mixed_step_paged``, the legacy chunk and decode, the engines
    (megastep, legacy, dense) and the lockstep decode give the reference's
    sampled ids, and their pools and caches equal the reference's bit for
    bit as uint8 (NaN-equal; block 0, where padding and idle rows write,
    left out);
  * a K that overflows e4m3 on live keys gives the reference's ids, the -1
    sentinel where its logits are not finite;
  * hibernate/wake, the disk tier and the dense engine's
    ``extract_slot``/``restore_slot`` move fp8 pages as their bits, and a
    slot crosses to the JAX engine and back through ``slot_payload_as``;
  * the tensor-parallel megastep at tp 2 (both shards on the CPU) gives
    the mesh-less pools;
  * MLA, the encoder-decoder, the hybrid and the SSM refuse an fp8 cache
    with ``ValueError``, beside the reference's own failure.

The kernels themselves read e4m3 pages only on the card
(tests/test_torch_kernels_gpu.py, ``-k fp8``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.decode_attention.kernel import decode_attention_bhd
from repro.kernels.paged_attention.kernel import (paged_attention_bhd,
                                                  paged_prefill_attention_bcd)
from repro.models import build as jax_build
from repro.models import transformer as jtr
from repro.serving import InferenceEngine as JaxDense
from repro.serving import PagedInferenceEngine as JaxPaged
from repro_torch.configs import get_smoke_config
from repro_torch.device import FP8, cast_to
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import build
from repro_torch.models import transformer as ttr
from repro_torch.serving import (DiskTierKVSwapStore, InferenceEngine,
                                 PagedInferenceEngine)
from repro_torch.weights import (numpy_to_torch, params_from_jax,
                                 slot_payload_as, torch_to_numpy)
from test_torch_kernels_gpu import dense_case, mixed_case

F8 = "float8_e4m3fn"
ARCHS = ["gemma-2b", "chatglm3-6b"]
PROMPTS = [np.arange(9) % 50, (np.arange(30) + 3) % 200,
           (np.arange(17) * 7) % 256]
KW = dict(num_blocks=33, block_size=8, max_batch=4, max_len=96,
          token_budget=16)
LEGACY_KW = dict(KW, prefill_chunk=8, megastep=False)


def _models(arch, **over):
    over = {"compute_dtype": "float32", "kv_cache_dtype": F8, **over}
    jcfg = jax_smoke(arch).replace(remat=False, **over)
    tcfg = get_smoke_config(arch).replace(remat=False, **over)
    params = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return jcfg, params, tcfg, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _bits_equal(got, want, skip_block0=False):
    """fp8 arrays (a port tensor or uint8 bits, a reference array) equal bit
    for bit, NaN equal to NaN whatever its sign; with ``skip_block0`` the
    pools' axis 1 from 1 on."""
    g = torch_to_numpy(got) if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    g, w = g.view(np.uint8), w.view(np.uint8)
    if skip_block0:
        g, w = g[:, 1:], w[:, 1:]
    nan = lambda x: (x & 0x7F) == 0x7F               # e4m3fn's NaNs
    assert g.shape == w.shape
    assert np.array_equal(nan(g), nan(w))
    assert np.array_equal(np.where(nan(g), 0, g), np.where(nan(w), 0, w))


# ---------------------------------------------------------------- the cast

def _f32_boundaries():
    tiny = 2.0 ** -9                                  # e4m3's least subnormal
    vals = [0.0, -0.0, 448.0, 449.0, 463.99, 464.0, 464.5, 465.0, 480.0,
            1e6, np.inf, -np.inf, np.nan, tiny, tiny / 2, tiny * 0.75,
            tiny * 1.5, tiny * 2.5, 2.0 ** -6, 2.0 ** -6 * 1.0625, 1e-30,
            0.0625 * 17 / 16, 240.0, 248.0, 256.0, 272.0]
    vals += [-v for v in vals]
    return np.asarray(vals, np.float32)


@pytest.mark.parametrize("inputs", ["bf16_all_patterns", "f32_boundaries",
                                    "f32_random"])
def test_cast_matches_the_reference(inputs):
    if inputs == "bf16_all_patterns":
        bits = np.arange(65536, dtype=np.uint16)
        x = bits.view(ml_dtypes.bfloat16)
        t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        x = (_f32_boundaries() if inputs == "f32_boundaries" else
             (np.random.default_rng(0).standard_normal(1 << 16) * 300)
             .astype(np.float32))
        t = torch.from_numpy(x)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    got = cast_to(t, FP8)
    _bits_equal(got, want)
    if inputs != "f32_random":
        # the trap: torch's own cast saturates where the reference's is NaN
        plain = t.to(FP8).view(torch.uint8).numpy()
        assert not np.array_equal(plain & 0x7F == 0x7F,
                                  want.view(np.uint8) & 0x7F == 0x7F)


# ------------------------------------------------- plain K1, K2, K4 on fp8

DTYPES = [("float32", 2e-3), ("bfloat16", 2e-2)]


def _fp8(a):
    """A float32 array as the reference's fp8 array and the port's fp8
    tensor (the same bits)."""
    j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    return j, numpy_to_torch(np.asarray(j))


def _q(a, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,C", [(("gqa", 3, 4, 2, 32, 32, 4), 8),
                                     (("mqa", 2, 8, 1, 64, 32, 3), 1),
                                     (("wide", 4, 4, 2, 32, 32, 10), 24)])
def test_plain_k1_on_fp8_pools_matches_pallas(shape, C, dtype, tol):
    _, b, hq, hkv, d, dv, npages = shape
    q, k, v, lens, vals, pt = mixed_case(b, C, hq, hkv, d, dv, 8, npages,
                                         seed=C + b)
    (jq, tq), (jk, tk), (jv, tv) = _q(q, dtype), _fp8(k), _fp8(v)
    want = paged_prefill_attention_bcd(jq, jk, jv, jnp.asarray(lens),
                                       jnp.asarray(vals), jnp.asarray(pt),
                                       interpret=True)
    got = pa.paged_prefill_attention(tq, tk, tv, *map(torch.from_numpy,
                                                      (lens, vals, pt)))
    assert got.dtype == tq.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,d,dv,blk,npages,lens", [
    (3, 4, 2, 32, 32, 16, 4, (37, 1, 64)),
    (2, 8, 1, 64, 64, 32, 3, (95, 17))])
def test_plain_k2_on_fp8_pools_matches_pallas(b, hq, hkv, d, dv, blk, npages,
                                              lens, dtype, tol):
    q, k, v, _, _, pt = mixed_case(b, 1, hq, hkv, d, dv, blk, npages,
                                   seed=blk + d)
    (jq, tq), (jk, tk), (jv, tv) = _q(q[:, 0], dtype), _fp8(k), _fp8(v)
    lens = np.asarray(lens, np.int32)
    want = paged_attention_bhd(jq, jk, jv, jnp.asarray(lens),
                               jnp.asarray(pt), interpret=True)
    got = pa.paged_attention(tq[:, None], tk, tv, torch.from_numpy(lens),
                             torch.from_numpy(pt))[:, 0]
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,S,d,dv,kvlen", [
    (2, 4, 2, 1024, 64, 64, 700), (2, 4, 4, 512, 64, 32, 130)])
def test_plain_k4_on_an_fp8_cache_matches_pallas(b, hq, hkv, S, d, dv, kvlen,
                                                 dtype, tol):
    q, k, v = dense_case(b, 1, S, hq, hkv, d, dv, seed=S + kvlen)
    (jq, tq), (jk, tk), (jv, tv) = _q(q, dtype), _fp8(k), _fp8(v)
    want = decode_attention_bhd(jq[:, 0], jk.transpose(0, 2, 1, 3),
                                jv.transpose(0, 2, 1, 3), kvlen, blk_k=256,
                                interpret=True)
    _close(da.decode_attention(tq, tk, tv, kvlen)[:, 0], want, tol)
    # per-row lengths (the dense engine) against the scalar reference
    # one row at a time
    lens = np.array([1, kvlen], np.int32)
    got = da.decode_attention(tq, tk, tv, torch.from_numpy(lens))[:, 0]
    for row, n in enumerate(lens):
        want = decode_attention_bhd(jq[row:row + 1, 0],
                                    jk[row:row + 1].transpose(0, 2, 1, 3),
                                    jv[row:row + 1].transpose(0, 2, 1, 3),
                                    int(n), blk_k=256, interpret=True)
        _close(got[row:row + 1], want, tol)


# ----------------------------------------------------------- the megastep

BLK, NPAGES, B = 8, 8, 4
_jit_step = jax.jit(jtr.mixed_step_paged, static_argnames=("cfg",))


def _pools(cfg, rng, nb):
    shape = (cfg.n_layers, nb, BLK, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.float32)
                       .astype(jnp.float8_e4m3fn)) for _ in "kv"]


def _mixed(models, C, seed):
    jcfg, params, tcfg, tp = models
    rng = np.random.default_rng(seed)
    nb = B * NPAGES + 1
    k, v = _pools(jcfg, rng, nb)
    toks = rng.integers(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    valids = np.array([0, 1, max(1, C // 2), C], np.int32)
    lens = np.array([0, 13, 9, NPAGES * BLK - C], np.int32)
    tables = rng.permutation(np.arange(1, nb))[: B * NPAGES].reshape(
        B, NPAGES).astype(np.int32)
    jids, jpools = _jit_step(params, {"k": jnp.asarray(k),
                                      "v": jnp.asarray(v)},
                             jnp.asarray(toks), jnp.asarray(lens),
                             jnp.asarray(valids), jnp.asarray(tables),
                             cfg=jcfg)
    tpools = {"k": numpy_to_torch(k), "v": numpy_to_torch(v)}
    tids = ttr.mixed_step_paged(tp, tpools, *map(torch.from_numpy,
                                                 (toks, lens, valids,
                                                  tables)), tcfg)
    return np.asarray(jids), jpools, tids.numpy(), tpools


@pytest.mark.parametrize("C", [1, 8, 32])
def test_mixed_step_on_fp8_pools_matches_reference(models, C):
    jids, jpools, tids, tpools = _mixed(models, C, seed=C)
    assert tpools["k"].dtype == FP8
    np.testing.assert_array_equal(tids[1:], jids[1:])   # row 0 is inactive
    for name in ("k", "v"):
        _bits_equal(tpools[name], jpools[name], skip_block0=True)


def test_overflowing_k_gives_the_reference_ids():
    """wk of the first layer scaled so that some rows' K exceed e4m3's
    range on live keys: the reference's cast makes them NaN, those rows'
    logits are not finite and their ids -1; torch's saturating ``.to``
    would have sampled a token there."""
    jcfg, params, tcfg, _ = _models("gemma-2b")
    wk = np.array(params["layers"]["attn"]["wk"])
    wk[0] *= 150.0
    params["layers"]["attn"]["wk"] = jnp.asarray(wk)
    tp = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    jids, jpools, tids, tpools = _mixed((jcfg, params, tcfg, tp), 8, seed=3)
    np.testing.assert_array_equal(tids, jids)
    assert (tids[1:] == -1).any() and (tids[1:] != -1).any()
    assert torch.isnan(tpools["k"][0, 1:].float()).any()
    for name in ("k", "v"):
        _bits_equal(tpools[name], jpools[name], skip_block0=True)


# ------------------------------------------------------------- the engines

def _two_turns(eng):
    rids = [eng.submit(p, max_new_tokens=6, retain=True) for p in PROMPTS]
    eng.run_to_completion()
    out = [list(eng.reqs[r].out_tokens) for r in rids]
    for r in rids:
        eng.extend(r, np.arange(5) + 1, 4)
    eng.run_to_completion()
    return out + [list(eng.reqs[r].out_tokens) for r in rids]


@pytest.mark.parametrize("kw", [KW, LEGACY_KW], ids=["megastep", "legacy"])
def test_paged_engine_on_fp8_pools_matches_reference(models, kw):
    jcfg, params, tcfg, tp = models
    jeng = JaxPaged(jcfg, params, **kw)
    eng = PagedInferenceEngine(tcfg, tp, device="cpu", **kw)
    assert _two_turns(eng) == _two_turns(jeng)
    assert eng.cache.pools()[0]["k"].dtype == FP8
    assert eng.cache.block_bytes * 2 == PagedInferenceEngine(
        tcfg.replace(kv_cache_dtype="bfloat16"), tp, device="cpu",
        **kw).cache.block_bytes
    for name, pool in zip("kv", (jeng.cache.k, jeng.cache.v)):
        _bits_equal(eng.cache.pools()[0][name], pool, skip_block0=True)


def test_legacy_decode_and_chunk_on_fp8_pools_match_reference(models):
    jcfg, params, tcfg, tp = models
    rng = np.random.default_rng(7)
    nb = 3 * 6 + 1
    k, v = _pools(jcfg, rng, nb)
    tables = rng.permutation(np.arange(1, nb)).reshape(3, 6).astype(np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    lens = np.array([0, 13, 6 * BLK - 1], np.int32)
    want, jpools = jtr.decode_step_paged(
        params, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(tok),
        jnp.asarray(lens), jnp.asarray(tables), jcfg)
    tpools = {"k": numpy_to_torch(k), "v": numpy_to_torch(v)}
    got = ttr.decode_step_paged(tp, tpools, torch.from_numpy(tok),
                                torch.from_numpy(lens),
                                torch.from_numpy(tables), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))
    for name in ("k", "v"):
        _bits_equal(tpools[name], jpools[name])
    chunk = rng.integers(0, jcfg.vocab_size, (1, 8)).astype(np.int32)
    want, jpools = jtr.prefill_chunk_paged(
        params, jpools, jnp.asarray(chunk), 13, 5, jnp.asarray(tables[1]),
        jcfg)
    got = ttr.prefill_chunk_paged(tp, tpools, torch.from_numpy(chunk), 13, 5,
                                  torch.from_numpy(tables[1]), tcfg)
    np.testing.assert_allclose(got.numpy()[:, :5], np.asarray(want)[:, :5],
                               atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        _bits_equal(tpools[name], jpools[name], skip_block0=True)


def test_dense_engine_on_an_fp8_cache_matches_reference(models):
    jcfg, params, tcfg, tp = models
    jeng = JaxDense(jcfg, params, max_slots=2, max_len=64)
    eng = InferenceEngine(tcfg, tp, max_slots=2, max_len=64, device="cpu")
    for e in (jeng, eng):
        for p in PROMPTS:
            e.submit(p, max_new_tokens=8)
    want = {r.rid: r.out_tokens for r in jeng.run_to_completion()}
    got = {r.rid: r.out_tokens for r in eng.run_to_completion()}
    assert got == want
    for name in ("k", "v"):
        assert eng.state[name].dtype == FP8
        _bits_equal(eng.state[name], jeng.state[name])


def test_lockstep_decode_on_an_fp8_cache_matches_reference(models):
    """``prefill`` into an fp8 decode state (the fresh K/V attend in f32
    through the full-sequence path, then are cast into the cache), then
    ``decode_step`` at a scalar length (K4's plain version on the fp8
    cache)."""
    jcfg, params, tcfg, tp = models
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jm, tm = jax_build(jcfg), build(tcfg)
    want, jstate = jtr.prefill(params, {"tokens": jnp.asarray(toks[:, :9])},
                               jcfg, state=jm.init_decode_state(2, 16))
    state = tm.init_decode_state(2, 16, device="cpu")
    got = ttr.prefill(tp, torch.from_numpy(toks[:, :9]), tcfg, state=state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for i in range(9, 12):
        want, jstate = jm.decode_step(params, jstate,
                                      jnp.asarray(toks[:, i:i + 1]), i)
        got = tm.decode_step(tp, state, torch.from_numpy(toks[:, i:i + 1]),
                             i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      np.asarray(want).argmax(-1))
    for name in ("k", "v"):
        _bits_equal(state[name], jstate[name])


# ------------------------------------------------ pages crossing as bits

@pytest.fixture(scope="module")
def gemma():
    return _models("gemma-2b")


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_hibernate_wake_moves_fp8_bits(gemma, tier, tmp_path):
    """A session's fp8 pages leave as uint8 bits (through the host swap
    tier, or spilled to disk and read back) and come back unchanged; the
    session then continues with an uninterrupted run's tokens."""
    _, _, tcfg, tp = gemma
    ref = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    a = ref.submit(PROMPTS[1], max_new_tokens=5, retain=True)
    ref.run_to_completion()
    ref.extend(a, np.arange(7) + 2, 5)
    ref.run_to_completion()
    store = (DiskTierKVSwapStore(str(tmp_path / "spill"), capacity_bytes=1)
             if tier == "disk" else None)
    eng = PagedInferenceEngine(tcfg, tp, device="cpu", swap_store=store,
                               **KW)
    rid = eng.submit(PROMPTS[1], max_new_tokens=5, retain=True)
    eng.submit(PROMPTS[2], max_new_tokens=3, retain=True)
    eng.run_to_completion()
    k, v = eng.cache.gather(eng.reqs[rid].table)
    assert k.dtype == np.uint8 and k.shape[0] == tcfg.n_layers
    eng.hibernate(rid)
    eng.hibernate(rid + 1)       # with capacity 1 B, rid is spilled
    if store is not None:
        assert store.tier_stats()["swap_disk_writebacks"] >= 1
    eng.wake(rid)
    if store is not None:
        assert store.tier_stats()["swap_disk_reads"] == 1
    k2, v2 = eng.cache.gather(eng.reqs[rid].table)
    np.testing.assert_array_equal(k, k2)
    np.testing.assert_array_equal(v, v2)
    eng.extend(rid, np.arange(7) + 2, 5)
    eng.run_to_completion()
    assert eng.reqs[rid].out_tokens == ref.reqs[a].out_tokens


def test_dense_slot_crosses_to_jax_and_back_as_bits(gemma):
    """``extract_slot`` gives the fp8 cache as uint8 bits; they restore
    into another port engine unchanged, and through ``slot_payload_as``
    into the JAX engine mid-decode, which then finishes with the port's
    tokens; the JAX engine's payload comes back the same way."""
    jcfg, params, tcfg, tp = gemma
    eng = InferenceEngine(tcfg, tp, max_slots=2, max_len=48, device="cpu")
    jeng = JaxDense(jcfg, params, max_slots=2, max_len=48)
    rid = eng.submit(PROMPTS[2], max_new_tokens=9)
    jrid = jeng.submit(PROMPTS[2], max_new_tokens=9)
    for _ in range(3):
        eng.step()
        jeng.step()
    payload, length = eng.extract_slot(eng.active[rid].slot)
    assert payload["k"].dtype == np.uint8
    other = InferenceEngine(tcfg, tp, max_slots=2, max_len=48, device="cpu")
    other.restore_slot(1, payload, length)
    for name in ("k", "v"):
        assert torch.equal(other.state[name][:, 1].view(torch.uint8),
                           eng.state[name][:, 0].view(torch.uint8))
    slot = jeng.active[jrid].slot
    jeng.restore_slot(slot, slot_payload_as(payload, ml_dtypes.bfloat16,
                                            ml_dtypes.float8_e4m3fn), length)
    for name in ("k", "v"):
        _bits_equal(payload[name], jeng.state[name][:, slot])
    want = {r.rid: r.out_tokens for r in eng.run_to_completion()}[rid]
    assert {r.rid: r.out_tokens
            for r in jeng.run_to_completion()}[jrid] == want
    back, back_len = jeng.extract_slot(slot)
    assert back["k"].dtype == jnp.float8_e4m3fn
    other.restore_slot(0, slot_payload_as(back, np.uint16, np.uint8),
                       back_len)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            torch_to_numpy(other.state[name][:, 0]),
            np.asarray(back[name]).view(np.uint8))


def test_tp2_pools_equal_the_meshless_ones():
    """The megastep at tp 2 (chatglm3-6b smoke's two kv heads, one a
    shard, both shards on the CPU): each shard's fp8 pool holds its heads'
    bits of the mesh-less pool, and the tokens are equal."""
    _, _, tcfg, tp = _models("chatglm3-6b")
    one = PagedInferenceEngine(tcfg, tp, device="cpu", **KW)
    two = PagedInferenceEngine(tcfg, tp, device="cpu",
                               mesh=make_tp_mesh(2, devices=["cpu"] * 2),
                               **KW)
    assert _two_turns(two) == _two_turns(one)
    assert [s["k"].dtype for s in two.cache.pools()] == [FP8, FP8]
    full = two.cache.full_pools()
    for got, want in zip(full, one.cache.full_pools()):
        _bits_equal(got, torch_to_numpy(want), skip_block0=True)


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-tiny",
                                  "zamba2-7b", "mamba2-370m"])
def test_fp8_refused_where_the_reference_fails(arch):
    """The reference keeps these caches (MLA's latent, the
    encoder-decoder's, the hybrid's rings and conv state, the SSM's conv
    state) in fp8 and its first decode step fails to promote them against
    bf16; the port refuses the cache with a ValueError."""
    jcfg = jax_smoke(arch).replace(kv_cache_dtype=F8)
    jm = jax_build(jcfg)
    params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    state = jax.eval_shape(lambda: jm.init_decode_state(1, 8))
    with pytest.raises(ValueError, match="promotion"):   # TypePromotionError
        jax.jit(jm.decode_step, static_argnums=3).lower(
            params, state, jax.ShapeDtypeStruct((1, 1), jnp.int32), 0)
    tcfg = get_smoke_config(arch).replace(kv_cache_dtype=F8)
    with pytest.raises(ValueError, match="TypePromotionError"):
        build(tcfg).init_decode_state(1, 8, device="cpu")
