"""The algorithms of the redesigned K1 and K2, in plain PyTorch on the CPU.

``paged_attention_split_ref`` is the split decode K2 runs (and K1 at
C = 1): key ranges, per-range partials merged in order; at float32 q
ranges of whole pages from the shapes, at bf16 q (``p_dtype``) ranges of
whole 64-key tiles cut from each row's length, four warps' online softmax
and P rounded before P.V;
``paged_prefill_attention_tiled_ref`` the tensor-core walk K1 runs at
C > 1: 64-row M tiles of chunk positions x the heads of one kv head, key
tiles of whole pages up to the tile's last visible key, an online softmax
in log2 units, P rounded before P.V, the key range optionally split into
ranges whose partials are merged in order. Both are held to the plain
versions (``paged_attention_ref``, ``paged_prefill_attention_ref``) and to
the Pallas kernels in interpret mode (the "kv_major" pairing they index):
float32 within 1e-5 (another summation order); bf16 within 1e-2 against
the plain versions and 2e-2 against Pallas (one bf16 rounding of the
output, plus P rounded to bf16 in the tiled walk). The split plans are
held at the serving paths' shapes. Inputs are numpy arrays from seeds,
handed to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import (paged_attention_bhd,
                                                  paged_prefill_attention_bcd)
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.paged_attention import ops, ref
from test_torch_kernels_gpu import decode_case, mixed_case

BF16 = torch.bfloat16


def _t(arrays, dtype=torch.float32):
    """numpy -> torch: float arrays in ``dtype``, int arrays as they are."""
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    if torch.is_tensor(want):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------- K2 (and K1 at C = 1): split

# (b, hq, hkv, d, dv, blk, npages): gemma-2b's heads, GQA, dv != d, blk 8
DECODE_SHAPES = [(3, 8, 1, 256, 256, 16, 4), (3, 4, 2, 32, 32, 8, 5),
                 (2, 8, 1, 64, 32, 8, 3), (4, 4, 4, 32, 32, 16, 6)]


# the split decode's two walks: the CUDA-core pass (float32 q: no P
# rounding) and the tensor-core one (bf16 q; at float32 here, P unrounded)
WALKS = {"cuda_cores": None, "tensor_cores": torch.float32}


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("split_pages", [1, 2, None])   # None: one range
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_ref_matches_plain(shape, pairing, split_pages, walk):
    """Ranges of one or two pages leave ranges wholly past the shorter
    rows (a row of length 1 is in every case): empty partials. The
    tensor-core walk cuts a split into whole 64-key tiles: ranges of one
    tile, cut from each row's length."""
    b, hq, hkv, d, dv, blk, npages = shape
    q, kp, vp, lens, pt = _t(decode_case(b, hq, hkv, d, dv, blk, npages,
                                         seed=d + blk))
    split = split_pages * blk if split_pages else npages * blk
    want = ref.paged_attention_ref(q, kp, vp, lens, pt, pairing=pairing)
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=split,
                                        pairing=pairing,
                                        p_dtype=WALKS[walk])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("p_dtype", [None, BF16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_ref_bf16(shape, p_dtype):
    """bf16 inputs, f32 math: one rounding of the output apart (and of P
    where the tensor-core walk rounds it)."""
    b, hq, hkv, d, dv, blk, npages = shape
    q, kp, vp, lens, pt = _t(decode_case(b, hq, hkv, d, dv, blk, npages,
                                         seed=d + blk), BF16)
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=blk,
                                        p_dtype=p_dtype)
    assert got.dtype == BF16
    _close(got, ref.paged_attention_ref(q, kp, vp, lens, pt), 1e-2)


@pytest.mark.parametrize("p_dtype", [None, BF16])
def test_split_ref_zero_length_row_gives_zeros(p_dtype):
    """K2 at lens 0 sees no key and writes zeros, as the Pallas kernel."""
    q, kp, vp, lens, pt = _t(decode_case(3, 4, 2, 32, 32, 8, 3, seed=0))
    lens[1] = 0
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=8,
                                        p_dtype=p_dtype)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 8, 1, 256, 256, 16, 3),
                                   (3, 4, 2, 32, 32, 8, 5)])
def test_split_ref_matches_pallas(shape, dtype, tol, walk):
    """The tensor-core walk in bf16 rounds P to bf16, as the kernel."""
    b, hq, hkv, d, dv, blk, npages = shape
    arrays = decode_case(b, hq, hkv, d, dv, blk, npages, seed=hq + blk)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    want = paged_attention_bhd(*(jnp.asarray(a, jd) for a in arrays[:3]),
                               jnp.asarray(arrays[3]),
                               jnp.asarray(arrays[4]), interpret=True)
    q, kp, vp, lens, pt = _t(arrays, td)
    p_dtype = td if WALKS[walk] is not None else None
    _close(ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=blk,
                                         p_dtype=p_dtype), want, tol)


@pytest.mark.parametrize("p_dtype", [None, torch.float32])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
def test_prefill_at_c1_is_the_split_decode(pairing, p_dtype):
    """K1 at C = 1 runs the split decode at length
    max(cache_lens + valids, 1); on rows with valids = 1 it is K2 at
    lens = cache_lens + 1, bit for bit, on either walk."""
    b, hq, hkv, d, dv, blk, npages = 6, 8, 1, 64, 64, 8, 4
    q, kp, vp, lens, vals, pt = _t(mixed_case(b, 1, hq, hkv, d, dv, blk,
                                              npages, seed=7))
    assert set(vals.tolist()) == {0, 1}
    got = ref.paged_prefill_attention_tiled_ref(q, kp, vp, lens, vals, pt,
                                                split=2 * blk,
                                                pairing=pairing,
                                                p_dtype=p_dtype)
    _close(got, ref.paged_prefill_attention_ref(q, kp, vp, lens, vals, pt,
                                                pairing=pairing), 1e-5)
    k2 = ref.paged_attention_split_ref(q[:, 0], kp, vp, lens + 1, pt,
                                       split=2 * blk, pairing=pairing,
                                       p_dtype=p_dtype)
    rows = vals == 1
    assert torch.equal(got[rows, 0], k2[rows])


# lengths at every edge of a page and a 64-key tile, and past them
EDGE_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000, 4095,
             4096, 5000, 8191, 8192]


@pytest.mark.parametrize("npages,blk,b,hq,hkv", [
    (512, 16, 16, 32, 2), (1024, 16, 16, 36, 4), (64, 16, 8, 8, 1),
    (1024, 8, 16, 32, 2), (5, 8, 3, 4, 2), (2048, 16, 1, 8, 1)])
def test_split_ranges_cover_every_key_once(npages, blk, b, hq, hkv):
    """The tensor-core split decode's ranges, cut on the device from each
    row's own length into the plan's n_split ranges: every key below the
    length (clamped to the table) in exactly one range, none past it, the
    ranges in order of whole 64-key tiles, each at most the plan's split
    (the page ids a block holds), the non-empty ones first (the merge reads
    ceil(tiles / per) of them), every range non-empty for a full row."""
    S = npages * blk
    split, n_split = ops.decode_plan(npages, blk, b, hq, hkv, 128, 128, 2,
                                     132)
    lens = torch.tensor([n for n in EDGE_LENS if n <= S + 100] + [S])
    k_lo, k_hi = ref.split_ranges(lens, n_split, S)
    assert k_lo.shape == (len(lens), n_split)
    for n, lo, hi in zip(lens.tolist(), k_lo.tolist(), k_hi.tolist()):
        seen = torch.zeros(S + 128, dtype=torch.int64)
        live = [z > a for a, z in zip(lo, hi)]
        assert live == sorted(live, reverse=True)
        tiles = -(-min(n, S) // ref.SPLIT_KEY_TILE)
        per = -(-tiles // n_split)
        assert sum(live) == (-(-tiles // per) if per else 0)
        for a, z in zip(lo, hi):
            assert a % ref.SPLIT_KEY_TILE == 0
            if z > a:
                assert z - a <= split
                seen[a:z] += 1
        assert seen[:min(n, S)].eq(1).all() and not seen[min(n, S):].any()
    full = ref.split_ranges(torch.tensor([S]), n_split, S)
    assert (full[1] > full[0]).all()


# --------------------------------------------- K1 at C > 1: the M tiles

# (b, C, hq, hkv, d, dv, blk, npages): gemma-2b's heads (one M tile holds
# 8 positions), GQA over several M tiles, MQA with dv != d, blk 8 and 16
TILE_SHAPES = [(2, 24, 8, 1, 256, 256, 16, 4), (4, 40, 4, 2, 32, 32, 8, 8),
               (2, 16, 8, 1, 64, 32, 8, 5), (2, 33, 4, 4, 32, 32, 16, 4)]


@pytest.mark.parametrize("split", [32, 64, None])    # None: one range
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tiled_ref_matches_plain(shape, pairing, split):
    """Ragged valids (full, decode-like, random; inactive at b = 4), so
    padding positions and ranges past a tile's keys are in every case."""
    b, C, hq, hkv, d, dv, blk, npages = shape
    args = _t(mixed_case(b, C, hq, hkv, d, dv, blk, npages, seed=C + d))
    want = ref.paged_prefill_attention_ref(*args, pairing=pairing)
    got = ref.paged_prefill_attention_tiled_ref(*args, split=split,
                                                pairing=pairing)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tiled_ref_bf16_with_p_rounded(shape, pairing):
    """bf16 inputs, P rounded to bf16 before P.V as the kernel does,
    against the plain version in bf16."""
    b, C, hq, hkv, d, dv, blk, npages = shape
    args = _t(mixed_case(b, C, hq, hkv, d, dv, blk, npages, seed=C + d), BF16)
    got = ref.paged_prefill_attention_tiled_ref(*args, split=32,
                                                pairing=pairing,
                                                p_dtype=BF16)
    assert got.dtype == BF16
    _close(got, ref.paged_prefill_attention_ref(*args, pairing=pairing),
           1e-2)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 16, 8, 1, 256, 256, 16, 3),
                                   (3, 24, 4, 2, 32, 32, 8, 5)])
def test_tiled_ref_matches_pallas(shape, dtype, tol):
    """The Pallas kernel maps q-head h to kv head h // g (kv_major)."""
    b, C, hq, hkv, d, dv, blk, npages = shape
    arrays = mixed_case(b, C, hq, hkv, d, dv, blk, npages, seed=hq + C)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    want = paged_prefill_attention_bcd(
        *(jnp.asarray(a, jd) for a in arrays[:3]),
        *(jnp.asarray(a) for a in arrays[3:]), interpret=True)
    got = ref.paged_prefill_attention_tiled_ref(
        *_t(arrays, td), split=32, p_dtype=td if td == BF16 else None)
    _close(got, want, tol)


def test_tiled_ref_history_ending_mid_page_and_inactive_rows():
    """Row 0 ends mid-page (cache 21 + 5 of blk 8), row 1 is inactive at
    cache 0 (every position sees key 0 of its first page, the null
    block's clamp), row 2 inactive mid-history; every pool slot at or past
    a row's kv_len holds NaN, which the walk zero-fills as the kernel's
    copy does, so the output equals the plain version on a pool where
    those slots are zeros."""
    b, C, hq, hkv, d, dv, blk, npages = 3, 12, 4, 2, 32, 32, 8, 5
    q, kp, vp, _, _, pt = _t(mixed_case(b, C, hq, hkv, d, dv, blk, npages,
                                    seed=3))
    lens = torch.tensor([21, 0, 17], dtype=torch.int32)
    vals = torch.tensor([5, 0, 0], dtype=torch.int32)
    kv_len = torch.clamp(lens + vals, min=1)
    stale = torch.arange(npages * blk)[None, :] >= kv_len[:, None]
    stale = stale.reshape(b, npages, blk)
    clean_k, clean_v = kp.clone(), vp.clone()
    for r in range(b):
        for j in range(npages):
            slots = stale[r, j]
            kp[int(pt[r, j]), slots] = float("nan")
            vp[int(pt[r, j]), slots] = float("nan")
            clean_k[int(pt[r, j]), slots] = 0.
            clean_v[int(pt[r, j]), slots] = 0.
    want = ref.paged_prefill_attention_ref(q, clean_k, clean_v, lens, vals,
                                           pt)
    for split in (16, None):
        got = ref.paged_prefill_attention_tiled_ref(q, kp, vp, lens, vals,
                                                    pt, split=split,
                                                    p_dtype=None)
        assert torch.isfinite(got).all()
        _close(got, want, 1e-5)
    # row 1: every position attends to key 0 alone
    key0_v = vp[int(pt[1, 0]), 0]                         # (hkv, dv)
    _close(got[1], key0_v.repeat_interleave(hq // hkv, 0)[None].expand(
        C, hq, dv), 1e-6)


# --------------------------------------------------------- the plans

# (q's element size, the decode plan at gemma-2b's decode step): float32
# splits into 22 ranges of 3 pages, 176 blocks; bf16 cuts each row's
# 64-key tiles (16 at full length) into 16 ranges of one tile, 128 blocks
GEMMA_DECODE_PLANS = [(4, (48, 22)), (2, (64, 16))]


@pytest.mark.parametrize("es,plan", GEMMA_DECODE_PLANS)
def test_plans_at_the_paths_shapes(es, plan):
    """gemma-2b (hq 8, hkv 1, d 256, pages of 16, 64 a row) on 132 SMs:
    the decode steps (b 8) as ``GEMMA_DECODE_PLANS``; the megastep's
    prefill bucket (b 8, C 32: 32 M tiles) into 6 ranges of 192 keys; the
    legacy chunk (b 1, C 32: 4 M tiles) into 32 ranges of one 32-key tile;
    C = 256 (256 M tiles) needs no split. The benchmark's decode steps in
    bf16 (16 rows, d 128, pages of 16; two blocks a SM): chatglm3-6b
    (hq 32 / hkv 2, 512 pages) in 8 ranges a row, 256 blocks;
    starcoder2-7b (36 / 4, 1,024 pages) in 4, 256 blocks."""
    assert ops.decode_plan(64, 16, 8, 8, 1, 256, 256, es, 132) == plan
    assert ops.prefill_plan(64, 16, 8, 32, 8, 1, 256, 256, 132) == (192, 6)
    assert ops.prefill_plan(64, 16, 1, 32, 8, 1, 256, 256, 132) == (32, 32)
    assert ops.prefill_plan(64, 16, 8, 256, 8, 1, 256, 256, 132) \
        == (1024, 1)
    assert ops.decode_plan(512, 16, 16, 32, 2, 128, 128, 2, 132) \
        == (1024, 8)
    assert ops.decode_plan(1024, 16, 16, 36, 4, 128, 128, 2, 132) \
        == (4096, 4)


@pytest.mark.parametrize("npages,blk,b,C,hq,hkv,d,n_sm", [
    (64, 16, 8, 32, 8, 1, 256, 132), (64, 16, 1, 32, 8, 1, 256, 132),
    (3, 8, 2, 24, 4, 2, 32, 132), (5, 8, 2, 64, 4, 1, 128, 114),
    (1, 16, 1, 8, 8, 1, 256, 132), (512, 16, 2, 64, 32, 4, 128, 132)])
def test_prefill_plan(npages, blk, b, C, hq, hkv, d, n_sm):
    """Ranges cover the npages * blk keys once; with more than one they are
    whole key tiles (so whole pages); the blocks fill every SM where
    key-tile ranges would."""
    S = npages * blk
    split, n_split = ops.prefill_plan(npages, blk, b, C, hq, hkv, d, d,
                                      n_sm)
    tile = 32 if d > 128 else 64
    assert n_split == -(-S // split)
    if n_split > 1:
        assert split % tile == 0 and split % blk == 0
    else:
        assert split == S
    n_mt = -(-C * (hq // hkv) // 64)
    if -(-S // tile) * b * hkv * n_mt >= n_sm:
        assert n_split * b * hkv * n_mt >= n_sm


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("npages,blk,b,hkv,n_sm", [
    (64, 16, 8, 1, 132), (64, 16, 1, 1, 132), (5, 8, 3, 2, 132),
    (2048, 16, 1, 1, 132), (64, 8, 8, 4, 114)])
def test_decode_plan(npages, blk, b, hkv, n_sm, es):
    """float32 (es 4): ranges of whole pages covering the keys once, at
    most the split that fits shared memory; enough blocks for every SM
    where one-page ranges would give them. bf16 (es 2): ranges of whole
    64-key tiles, n_split of them covering a full row's tiles once, enough
    for every block an SM holds (one at d 256) where one-tile ranges would
    give them, at most ``MAX_RANGE_PAGES`` pages a range."""
    S = npages * blk
    split, n_split = ops.decode_plan(npages, blk, b, 8, hkv, 256, 256, es,
                                     n_sm)
    if es == 4:
        assert split % blk == 0 and n_split == -(-S // split)
        assert split <= da._max_split(8 // hkv, 256, 256, es, align=blk,
                                      id_bytes=4)
        if npages * b * hkv >= n_sm:
            assert n_split * b * hkv >= n_sm
        return
    tile = ref.SPLIT_KEY_TILE
    tiles = -(-S // tile)
    assert split % tile == 0 and n_split == -(-tiles // (split // tile))
    assert split // blk <= ops.MAX_RANGE_PAGES
    want = max(n_sm // (b * hkv), 1)                  # one block a SM
    assert n_split >= min(want, tiles)


@pytest.mark.parametrize("g,d,dv,es,blk", [(8, 256, 256, 4, 16),
                                           (8, 256, 256, 2, 16),
                                           (8, 256, 256, 4, 8),
                                           (1, 64, 64, 4, 8),
                                           (8, 256, 256, 2, 8),
                                           (16, 128, 128, 2, 16)])
def test_decode_split_fits_shared_memory(g, d, dv, es, blk):
    """float32: the most keys a range takes, whole pages, fits an H100
    block's shared memory and one page more does not. bf16: the
    tensor-core pass at a one-row plan's ranges (the most page ids), its
    bf16 and e4m3 layouts; at d 128 two blocks fit an SM."""
    if es == 2:
        split, _ = ops.decode_plan(512, blk, 1, g, 1, d, dv, es, 1)
        for fp8 in (False, True):
            assert ops.split_smem(d, dv, blk, split, fp8) <= da.SMEM_BYTES
        if d <= 128:
            assert 2 * (ops.split_smem(d, dv, blk, split, False) + 1024) \
                <= ops.SM_SMEM_BYTES
        return
    split = da._max_split(g, d, dv, es, align=blk, id_bytes=4)
    assert split % blk == 0 and split <= da.MAX_SPLIT

    def used(s):     # K4's layout, then the range's page ids (16-byte unit)
        return da.smem_bytes(s, g, d, dv, es) + (s // blk * 4 + 15) // 16 * 16

    assert used(split) <= da.SMEM_BYTES
    if split + blk <= da.MAX_SPLIT:
        assert used(split + blk) > da.SMEM_BYTES


def test_kernel_plan_routes_by_shape(monkeypatch):
    """C = 1 takes the split decode (bf16 on the tensor cores, f32 on the
    CUDA cores), bf16 C > 1 the tensor cores, f32 C > 1 the walk; the
    twin's reshaped pool has the paged call's plan."""
    monkeypatch.setattr(da, "sm_count", lambda dev: 132)
    q, kp, vp, lens, vals, pt = _t(mixed_case(8, 32, 8, 1, 256, 256, 16,
                                              64, seed=0), BF16)
    plan = ops.kernel_plan(q, kp, vp, pt)
    assert plan["route"] == "tensor_cores" and plan["n_split"] == 6
    assert plan["blocks"] == [32 * 6, 8 * 32 * 8]
    assert ops.kernel_plan(q[:, :1], kp, vp, pt) == {
        "route": "split_mma", "split": 64, "n_split": 16, "key_tile": 64,
        "blocks": [16 * 8, 8 * 8]}
    assert ops.kernel_plan(q[:, :1].float(), kp.float(), vp.float(),
                           pt)["route"] == "split"
    assert ops.kernel_plan(q.float(), kp.float(), vp.float(),
                           pt)["route"] == "walk"
    # g 18 over two kv heads: two M tiles a (row, kv head)
    q18 = torch.zeros((8, 1, 36, 256), dtype=BF16)
    kp2 = torch.zeros((8 * 64 + 1, 16, 2, 256), dtype=BF16)
    plan18 = ops.kernel_plan(q18, kp2, kp2, pt)
    assert plan18["blocks"] == [plan18["n_split"] * 2 * 2 * 8, 8 * 36]
    kc = ref.gather_pages(kp, pt)
    pool = kc.reshape(8 * 64, 16, 1, 256)
    assert ops.kernel_plan(q, pool, pool, pt) == plan


def test_wrappers_on_cpu_take_the_plain_versions():
    """The wrappers' CPU path is the plain version, bit for bit, and counts
    no launch."""
    args = _t(mixed_case(3, 8, 4, 2, 32, 32, 8, 4, seed=1))
    before = (ops.paged_prefill_attention.launches,
              ops.paged_attention.launches)
    assert torch.equal(ops.paged_prefill_attention(*args, pairing="g_major"),
                       ref.paged_prefill_attention_ref(*args,
                                                       pairing="g_major"))
    q, kp, vp, lens, pt = _t(decode_case(3, 4, 2, 32, 32, 8, 4, seed=1))
    assert torch.equal(ops.paged_attention(q[:, None], kp, vp, lens, pt)[:, 0],
                       ref.paged_attention_ref(q, kp, vp, lens, pt))
    assert before == (ops.paged_prefill_attention.launches,
                      ops.paged_attention.launches)
