"""The algorithms of the redesigned K1 and K2, in plain PyTorch on the CPU.

``paged_attention_split_ref`` is the split decode K2 runs (and K1 at
C = 1): key ranges of whole pages, per-range partials merged in order;
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


@pytest.mark.parametrize("split_pages", [1, 2, None])   # None: one range
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_ref_matches_plain(shape, pairing, split_pages):
    """Ranges of one or two pages leave ranges wholly past the shorter
    rows (a row of length 1 is in every case): empty partials."""
    b, hq, hkv, d, dv, blk, npages = shape
    q, kp, vp, lens, pt = _t(decode_case(b, hq, hkv, d, dv, blk, npages,
                                         seed=d + blk))
    split = split_pages * blk if split_pages else npages * blk
    want = ref.paged_attention_ref(q, kp, vp, lens, pt, pairing=pairing)
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=split,
                                        pairing=pairing)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_ref_bf16(shape):
    """bf16 inputs, f32 math: one rounding of the output apart."""
    b, hq, hkv, d, dv, blk, npages = shape
    q, kp, vp, lens, pt = _t(decode_case(b, hq, hkv, d, dv, blk, npages,
                                         seed=d + blk), BF16)
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=blk)
    assert got.dtype == BF16
    _close(got, ref.paged_attention_ref(q, kp, vp, lens, pt), 1e-2)


def test_split_ref_zero_length_row_gives_zeros():
    """K2 at lens 0 sees no key and writes zeros, as the Pallas kernel."""
    q, kp, vp, lens, pt = _t(decode_case(3, 4, 2, 32, 32, 8, 3, seed=0))
    lens[1] = 0
    got = ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=8)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 8, 1, 256, 256, 16, 3),
                                   (3, 4, 2, 32, 32, 8, 5)])
def test_split_ref_matches_pallas(shape, dtype, tol):
    b, hq, hkv, d, dv, blk, npages = shape
    arrays = decode_case(b, hq, hkv, d, dv, blk, npages, seed=hq + blk)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    want = paged_attention_bhd(*(jnp.asarray(a, jd) for a in arrays[:3]),
                               jnp.asarray(arrays[3]),
                               jnp.asarray(arrays[4]), interpret=True)
    q, kp, vp, lens, pt = _t(arrays, td)
    _close(ref.paged_attention_split_ref(q, kp, vp, lens, pt, split=blk),
           want, tol)


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
def test_prefill_at_c1_is_the_split_decode(pairing):
    """K1 at C = 1 runs the split decode at length
    max(cache_lens + valids, 1); on rows with valids = 1 it is K2 at
    lens = cache_lens + 1, bit for bit."""
    b, hq, hkv, d, dv, blk, npages = 6, 8, 1, 64, 64, 8, 4
    q, kp, vp, lens, vals, pt = _t(mixed_case(b, 1, hq, hkv, d, dv, blk,
                                              npages, seed=7))
    assert set(vals.tolist()) == {0, 1}
    got = ref.paged_prefill_attention_tiled_ref(q, kp, vp, lens, vals, pt,
                                                split=2 * blk,
                                                pairing=pairing)
    _close(got, ref.paged_prefill_attention_ref(q, kp, vp, lens, vals, pt,
                                                pairing=pairing), 1e-5)
    k2 = ref.paged_attention_split_ref(q[:, 0], kp, vp, lens + 1, pt,
                                       split=2 * blk, pairing=pairing)
    rows = vals == 1
    assert torch.equal(got[rows, 0], k2[rows])


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

def test_plans_at_the_paths_shapes():
    """gemma-2b (hq 8, hkv 1, d 256, pages of 16, 64 a row) on 132 SMs:
    the decode steps (b 8) split into 22 ranges of 3 pages, 176 blocks;
    the megastep's prefill bucket (b 8, C 32: 32 M tiles) into 6 ranges
    of 192 keys; the legacy chunk (b 1, C 32: 4 M tiles) into 32 ranges
    of one 32-key tile; C = 256 (256 M tiles) needs no split."""
    assert ops.decode_plan(64, 16, 8, 8, 1, 256, 256, 2, 132) == (48, 22)
    assert ops.decode_plan(64, 16, 8, 8, 1, 256, 256, 4, 132) == (48, 22)
    assert ops.prefill_plan(64, 16, 8, 32, 8, 1, 256, 256, 132) == (192, 6)
    assert ops.prefill_plan(64, 16, 1, 32, 8, 1, 256, 256, 132) == (32, 32)
    assert ops.prefill_plan(64, 16, 8, 256, 8, 1, 256, 256, 132) \
        == (1024, 1)


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


@pytest.mark.parametrize("npages,blk,b,hkv,n_sm", [
    (64, 16, 8, 1, 132), (64, 16, 1, 1, 132), (5, 8, 3, 2, 132),
    (2048, 16, 1, 1, 132), (64, 8, 8, 4, 114)])
def test_decode_plan(npages, blk, b, hkv, n_sm):
    """Ranges of whole pages covering the keys once, at most the split that
    fits shared memory; enough blocks for every SM where one-page ranges
    would give them."""
    S = npages * blk
    split, n_split = ops.decode_plan(npages, blk, b, 8, hkv, 256, 256, 2,
                                     n_sm)
    assert split % blk == 0 and n_split == -(-S // split)
    assert split <= da._max_split(8 // hkv, 256, 256, 2, align=blk,
                                  id_bytes=4)
    if npages * b * hkv >= n_sm:
        assert n_split * b * hkv >= n_sm


@pytest.mark.parametrize("g,d,dv,es,blk", [(8, 256, 256, 4, 16),
                                           (8, 256, 256, 2, 16),
                                           (8, 256, 256, 4, 8),
                                           (1, 64, 64, 4, 8)])
def test_decode_split_fits_shared_memory(g, d, dv, es, blk):
    split = da._max_split(g, d, dv, es, align=blk, id_bytes=4)
    assert split % blk == 0 and split <= da.MAX_SPLIT

    def used(s):     # K4's layout, then the range's page ids (16-byte unit)
        return da.smem_bytes(s, g, d, dv, es) + (s // blk * 4 + 15) // 16 * 16

    assert used(split) <= da.SMEM_BYTES
    if split + blk <= da.MAX_SPLIT:
        assert used(split + blk) > da.SMEM_BYTES


def test_kernel_plan_routes_by_shape(monkeypatch):
    """C = 1 takes the split decode, bf16 C > 1 the tensor cores, f32
    C > 1 the walk; the twin's reshaped pool has the paged call's plan."""
    monkeypatch.setattr(da, "sm_count", lambda dev: 132)
    q, kp, vp, lens, vals, pt = _t(mixed_case(8, 32, 8, 1, 256, 256, 16,
                                              64, seed=0), BF16)
    plan = ops.kernel_plan(q, kp, vp, pt)
    assert plan["route"] == "tensor_cores" and plan["n_split"] == 6
    assert plan["blocks"] == [32 * 6, 8 * 32 * 8]
    assert ops.kernel_plan(q[:, :1], kp, vp, pt)["route"] == "split"
    assert ops.kernel_plan(q.float(), kp.float(), vp.float(),
                           pt)["route"] == "walk"
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
