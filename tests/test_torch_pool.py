"""The port's ``PagedKVCache.write_prefill`` / ``set_pools`` against the
reference's pool on the same inputs, at tp 1 and 2 (every shard on the
CPU), mirroring ``tests/test_paging.py``'s
``test_pool_write_prefill_and_scatter_roundtrip``: the prefill KV lands in
the sequence's blocks (the partial last page zero-padded), gather returns
the reference's bytes, scatter rebinds host pages bit for bit, and
``set_pools`` takes back the list ``pools()`` gives."""
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.serving.paging.pool import PagedKVCache as RefCache
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.serving.paging.pool import PagedKVCache

ARCH = "starcoder2-7b"          # smoke: 2 KV heads of 16, bf16 pools


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("tp", [1, 2])
def test_write_prefill_and_set_pools_match_reference(tp):
    want = RefCache(jax_smoke(ARCH), num_blocks=9, block_size=8)
    cache = PagedKVCache(get_smoke_config(ARCH), num_blocks=9, block_size=8,
                         device="cpu",
                         mesh=make_tp_mesh(tp, devices=["cpu"] * tp))
    assert len(cache.pools()) == tp
    L, _, blk, hkv, hd = want.k.shape
    plen = 13                                    # 2 pages, partial last
    rng = np.random.default_rng(3)
    k_pre = rng.standard_normal((L, plen, hkv, hd)).astype(np.float32)
    v_pre = rng.standard_normal((L, plen, hkv, hd)).astype(np.float32)
    ref_pt, pt = want.alloc_table(plen), cache.alloc_table(plen)
    want.write_prefill(ref_pt, k_pre, v_pre)
    cache.write_prefill(pt, k_pre, v_pre)
    assert pt.blocks == ref_pt.blocks and pt.num_tokens == plen
    kw, vw = want.gather(ref_pt)
    kg, vg = cache.gather(pt)
    np.testing.assert_array_equal(kg, _bits(kw))
    np.testing.assert_array_equal(vg, _bits(vw))
    assert (kg.reshape(L, -1, hkv, hd)[:, plen:] == 0).all()  # padded tail
    for got, ref in zip(cache.full_pools(), (want.k, want.v)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      _bits(ref).view(np.int16))
    # swap-style roundtrip: host pages -> fresh blocks, same bytes
    ref_pt2, pt2 = want.scatter(kw, vw, plen), cache.scatter(kg, vg, plen)
    assert pt2.blocks == ref_pt2.blocks
    np.testing.assert_array_equal(cache.gather(pt2)[0],
                                  _bits(want.gather(ref_pt2)[0]))
    # tensors write as host arrays do
    pt3 = cache.alloc_table(plen)
    cache.write_prefill(pt3, torch.from_numpy(k_pre), torch.from_numpy(v_pre))
    np.testing.assert_array_equal(cache.gather(pt3)[0], kg)
    # set_pools: the list pools() returns, rebound shard by shard
    fresh = [{n: t.clone() for n, t in shard.items()}
             for shard in cache.pools()]
    cache.set_pools(fresh)
    assert all(a["k"] is b["k"] and a["v"] is b["v"]
               for a, b in zip(cache.pools(), fresh))
    np.testing.assert_array_equal(cache.gather(pt)[0], kg)
    with pytest.raises(ValueError, match="shards"):
        cache.set_pools(fresh + fresh)
    with pytest.raises(ValueError, match="pool k"):
        cache.set_pools([{"k": s["k"][:, :1], "v": s["v"]} for s in fresh])
    for t in (pt, pt2, pt3):
        cache.free_table(t)
    assert cache.allocator.num_used == 0
