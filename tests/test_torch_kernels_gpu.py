"""The port's CUDA kernels against their plain PyTorch versions on the card:
K1 (paged chunked prefill), K2 (paged decode), K3 (flash attention), K4
(decode over a contiguous cache) and K5 (the Mamba-2 SSD chunked scan);
K3's and K5's gradients (their autograd Functions) against autograd of
the plain versions, and the smoke models' gradients on the card against
the CPU's; the captured steps (the serving dispatches and the train step)
against the eager ones.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(the kernels have no CPU mode). This file imports no jax, so it runs on a
machine with a card and no JAX; it also holds the inputs that
test_torch_paged_attention.py and test_torch_attention_kernels.py share:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

# test_megastep.py's generator: shuffled non-null pages, ragged valids
# (full, decode-like, random, inactive), chunks kept inside the table.
# Plain numpy from a seed, so test_torch_paged_attention.py hands the same
# arrays to the JAX side.
BLOCK_SIZE = 8
SHAPES = {   # (b, hq, hkv, d, dv, npages)
    "gqa": (3, 4, 2, 32, 32, 4),
    "mqa": (2, 8, 1, 64, 32, 3),
    "wide": (4, 4, 2, 32, 32, 10),
}
CASES = [(s, C) for s in ("gqa", "mqa") for C in (1, 8, 16)] + \
    [("wide", 24), ("wide", 64)]


def mixed_case(b, C, hq, hkv, d, dv, blk, npages, seed):
    rng = np.random.default_rng(seed)
    nb = b * npages + 1
    q = rng.standard_normal((b, C, hq, d)).astype(np.float32)
    k_pool = rng.standard_normal((nb, blk, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((nb, blk, hkv, dv)).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))[: b * npages].reshape(b, npages)
    valids = rng.integers(0, C + 1, size=b)
    valids[0] = C
    if b > 1:
        valids[1] = min(1, C)
    if b > 3:
        valids[3] = 0
    cache = rng.integers(0, (npages - 1) * blk, size=b)
    cache = np.minimum(cache, npages * blk - C)
    return (q, k_pool, v_pool, cache.astype(np.int32),
            valids.astype(np.int32), ids.astype(np.int32))


def case(shape, C):
    """(q, k_pool, v_pool, cache_lens, valids, page_tables) as numpy."""
    b, hq, hkv, d, dv, npages = SHAPES[shape]
    return mixed_case(b, C, hq, hkv, d, dv, BLOCK_SIZE, npages,
                      seed=C * 100 + b)


def decode_case(b, hq, hkv, d, dv, blk, npages, seed):
    """Paged decode inputs as numpy: q (b, hq, d), shuffled non-null
    pages, lens in [1, npages*blk] with one row at 1 and one full."""
    q, k_pool, v_pool, _, _, pt = mixed_case(b, 1, hq, hkv, d, dv, blk,
                                             npages, seed)
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(1, npages * blk + 1, size=b)
    lens[0] = 1
    lens[-1] = npages * blk
    return q[:, 0], k_pool, v_pool, lens.astype(np.int32), pt


def dense_case(b, s_q, s_kv, hq, hkv, d, dv, seed):
    """q (b, sq, hq, d), k (b, skv, hkv, d), v (b, skv, hkv, dv) as numpy,
    in the model's layout."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s_q, hq, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, hkv, dv)).astype(np.float32))


# (b, hq, hkv, d, dv, npages); blk 16 is gemma-2b's serving page size
DECODE_SHAPES = [(3, 4, 2, 32, 32, 4), (2, 8, 1, 64, 32, 3),
                 (4, 8, 1, 256, 256, 6)]
# (b, sq, hq, hkv, d, dv, causal): ragged sq, MQA, GQA, dv != d,
# zamba2-7b's heads (d = 112, g = 1) and deepseek-v2-lite's MLA forward
# (16 heads, d 192, dv 128, 2 rows of 512)
FLASH_SHAPES = [(2, 33, 4, 2, 64, 64, True), (1, 96, 8, 1, 256, 256, True),
                (2, 40, 4, 1, 64, 32, False), (1, 7, 6, 6, 32, 32, True),
                (1, 130, 4, 2, 128, 128, True),
                (1, 130, 4, 4, 112, 112, True),
                (2, 512, 16, 16, 192, 128, True)]
# (b, S, hq, hkv, d, dv); S = 1003 lies off every split, with a row of
# length 1 in it; llava-next's decode after its image prefix (hq 32, hkv 8,
# d 128, a 656-position cache)
DENSE_DECODE_SHAPES = [(4, 100, 8, 1, 256, 256), (2, 64, 4, 2, 32, 32),
                       (3, 48, 4, 4, 64, 32), (2, 1003, 8, 2, 64, 64),
                       (2, 656, 32, 8, 128, 128)]
DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]
# Against the plain versions that walk as the kernels do (the tiled flash
# walk with P rounded to bf16, the split-K decode from the kernel's plan,
# in bf16 its tensor-core walk with P rounded), in float32 out: bf16
# outputs are one rounding apart, at most half a bf16 ulp (2^-8
# relative); K3 also flips a rare rounding of P.
# K1 (tensor-core tiles at C > 1) as K3; K2 and K1 at C = 1 (the split
# decode) as K4, but K1 keeps K3's looser bound at every C.
TIGHT = {"K1": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-3, 4e-3)},
         "K2": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 4e-3)},
         "K3": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-3, 4e-3)},
         "K4": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 4e-3)}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


TENSOR_CORE_ROUTES = ("tensor_cores", "split_mma")


def _k1_walk(args, pairing):
    """The walk K1 runs for these CUDA tensors (its plan's key ranges; P
    rounded to bf16 on the tensor cores), in float32."""
    q, k, v, lens, vals, pt = args
    plan = ops.kernel_plan(q, k, v, pt)
    return ref.paged_prefill_attention_tiled_ref(
        q.float(), k.float(), v.float(), lens, vals, pt,
        split=plan["split"], pairing=pairing,
        p_dtype=q.dtype if plan["route"] in TENSOR_CORE_ROUTES else None)


def _check_k1(args, pairing, dtype, tol):
    """K1 against its plain version (``tol``) and its walk (TIGHT), equal
    bits on a second call and from the gathered-view twin; one launch
    counted per call."""
    before = ops.paged_prefill_attention.launches
    got = ops.paged_prefill_attention(*args, pairing=pairing)
    again = ops.paged_prefill_attention(*args, pairing=pairing)
    want = ref.paged_prefill_attention_ref(*args, pairing=pairing)
    walk = _k1_walk(args, pairing)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    atol, rtol = TIGHT["K1"][dtype]
    torch.testing.assert_close(got.float(), walk, atol=atol, rtol=rtol)
    q, k, v, lens, vals, pt = args
    twin = ops.paged_prefill_attention_contig(
        q, ref.gather_pages(k, pt), ref.gather_pages(v, pt), lens, vals, pt,
        pairing=pairing)
    assert torch.equal(got, twin)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape,C", CASES)
def test_cuda_kernel_matches_plain(cuda, shape, C, pairing, dtype, tol):
    """bf16: one bf16 rounding apart at outputs below ~1.5; f32: another
    summation order. Against the walk it runs (TIGHT); the gathered-view
    twin and a second call are equal bit for bit."""
    args = [torch.from_numpy(x).to(cuda) for x in case(shape, C)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    _check_k1(args, pairing, dtype, tol)


# (b, C, npages) at gemma-2b's heads and pages (hq 8, hkv 1, d 256, blk 16):
# the megastep's prefill bucket and the legacy chunk (key ranges split),
# the C = 256 bucket (one range), and a decode step (C = 1)
GEMMA_PAGED = [(8, 32, 64), (1, 32, 64), (8, 256, 64), (8, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("b,C,npages", GEMMA_PAGED)
def test_cuda_kernel_at_the_paths_shapes(cuda, b, C, npages, pairing):
    """K1 in bf16 at the serving paths' shapes, split or not as its plan
    says; the twin has the same shapes, so the same plan and bits."""
    args = [torch.from_numpy(x).to(cuda) for x in
            mixed_case(b, C, 8, 1, 256, 256, 16, npages, seed=b + C)]
    args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
    plan = ops.kernel_plan(*args[:3], args[5])
    assert plan["route"] == ("split_mma" if C == 1 else "tensor_cores")
    _check_k1(args, pairing, torch.bfloat16, 1e-2)


# (hq, hkv): llama4-scout's heads (g = 5) and starcoder2-7b's (g = 9), whose
# M tiles hold a chunk position's heads across a tile boundary, at d 128
ODD_GROUPS = [(40, 8), (36, 4),
              # starcoder2-7b's heads per shard of the tensor-parallel
              # megastep: tp 2 and tp 4
              (18, 2), (9, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 32])
@pytest.mark.parametrize("hq,hkv", ODD_GROUPS)
def test_cuda_kernel_at_odd_gqa_groups(cuda, hq, hkv, C):
    args = [torch.from_numpy(x).to(cuda) for x in
            mixed_case(4, C, hq, hkv, 128, 128, 16, 8, seed=hq + C)]
    args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
    _check_k1(args, "g_major", torch.bfloat16, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("blk", [8, 16])
def test_k2_equals_k1_at_c1(cuda, blk, pairing, dtype):
    """K2 at lens = cache_lens + 1 runs K1's C = 1 kernel and plan: equal
    bits on every row with valids = 1."""
    q, k, v, lens, vals, pt = (torch.from_numpy(x).to(cuda) for x in
                               mixed_case(6, 1, 8, 1, 256, 256, blk, 8,
                                          seed=blk))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    k1 = ops.paged_prefill_attention(q, k, v, lens, vals, pt,
                                     pairing=pairing)
    k2 = ops.paged_attention(q, k, v, lens + 1, pt, pairing=pairing)
    torch.cuda.synchronize()
    rows = vals == 1
    assert rows.any() and (~rows).any()
    assert torch.equal(k1[rows], k2[rows])


# ------------------------- the tensor-core split decode (bf16, C = 1)

def _split_inputs(dev, b, hq, hkv, d, dv, npages, lens, seed, blk=16,
                  dtype=torch.bfloat16):
    """q (b, 1, hq, d), pools over shuffled non-null pages, lens (b,) and
    tables, drawn on the card (the cells' tables hold 512-1024 pages a
    row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * npages + 1
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((nb, blk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((nb, blk, hkv, dv), generator=g, device=dev).to(dtype)
    ids = torch.randperm(nb - 1, generator=g, device=dev)[: b * npages] + 1
    return (q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev),
            ids.reshape(b, npages).to(torch.int32))


def _check_split(q, k, v, lens, pt, pairing, tol=1e-2):
    """K2 and K1 (at cache_lens = lens - 1, valids 1) on the tensor-core
    split route: against the plain version (rows of length 0: zeros) and
    the walk it runs (TIGHT), equal bits on a second call and between K2
    and K1, one launch a call counted under "split_mma"."""
    plan = ops.kernel_plan(q, k, v, pt)
    assert plan["route"] == "split_mma"
    by_route = dict(ops.paged_attention.launches_by_route)
    got = ops.paged_attention(q, k, v, lens, pt, pairing=pairing)
    again = ops.paged_attention(q, k, v, lens, pt, pairing=pairing)
    live = lens > 0
    ones = torch.ones_like(lens)
    k1 = ops.paged_prefill_attention(q, k, v, torch.clamp(lens - 1, min=0),
                                     ones, pt, pairing=pairing)
    walk = ref.paged_attention_split_ref(
        q[:, 0].float(), k.float(), v.float(), lens, pt,
        split=plan["split"], pairing=pairing, p_dtype=q.dtype)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches_by_route.get("split_mma", 0) \
        == by_route.get("split_mma", 0) + 2
    assert torch.equal(got, again)
    assert torch.equal(k1[live], got[live])
    assert not got[~live].any()
    want = ref.paged_attention_ref(q[live, 0], k, v, lens[live], pt[live],
                                   pairing=pairing)
    torch.testing.assert_close(got[live, 0].float(), want.float(), atol=tol,
                               rtol=tol)
    atol, rtol = TIGHT["K1"][torch.bfloat16]
    torch.testing.assert_close(got[:, 0].float(), walk, atol=atol, rtol=rtol)
    return got


# (hq, hkv, npages, lengths): chatglm3-6b's decode cell (hq 32 / hkv 2,
# 512 pages a row, lengths 1-5k) and starcoder2-7b's fleet (36 / 4, 1,024
# pages, 1-3k), d 128, pages of 16, 16 rows
SPLIT_CELLS = [(32, 2, 512, (1, 5000)), (36, 4, 1024, (1, 3000))]


@pytest.mark.gpu
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("hq,hkv,npages,span", SPLIT_CELLS)
def test_split_mma_at_the_cells_shapes(cuda, hq, hkv, npages, span,
                                       pairing):
    lens = np.random.default_rng(hq).integers(span[0], span[1] + 1, 16)
    _check_split(*_split_inputs(cuda, 16, hq, hkv, 128, 128, npages,
                                lens.tolist(), seed=hq), pairing)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (256, 256),
                                  (64, 32), (128, 256), (40, 24)])
@pytest.mark.parametrize("g", [1, 5, 8, 9, 16, 18])
def test_split_mma_groups_and_head_dims(cuda, g, d, dv):
    """Groups below, at and past one 16-row M tile (g 18: two), every head
    dim the exact and general builds take, dv != d, rows padded to 16."""
    lens = [1, 17, 64, 200, 0, 129]
    _check_split(*_split_inputs(cuda, 6, 2 * g, 2, d, dv, 16, lens,
                                seed=g * d + dv), "g_major")


@pytest.mark.gpu
@pytest.mark.parametrize("blk", [8, 16])
def test_split_mma_lengths(cuda, blk):
    """Lengths at every edge of a page and a 64-key tile, a row past half
    the table, and a ragged 1-5k batch, at chatglm3-6b's heads."""
    rng = np.random.default_rng(blk)
    lens = [0, 1, 15, 16, 17, 63, 64, 65, 4095] + \
        rng.integers(1, 5001, 7).tolist()
    _check_split(*_split_inputs(cuda, 16, 32, 2, 128, 128, 8192 // blk,
                                lens, seed=blk, blk=blk), "g_major")


@pytest.mark.gpu
@pytest.mark.parametrize("fp8", [False, True])
def test_split_mma_graph_replay_follows_the_lengths(cuda, fp8):
    """The grid comes from the shapes and the ranges from the lengths on
    the device: a K2 and a K1 call captured in a CUDA graph, replayed
    after the lengths change, give the eager calls' bits; the capture
    counts one launch of "split_mma" per call."""
    q, k, v, lens, pt = _split_inputs(cuda, 16, 32, 2, 128, 128, 512,
                                      [4000] * 16, seed=5)
    if fp8:
        k, v = _fp8(k, v)
    vals = torch.ones_like(lens)
    cache = lens - 1
    by_route = dict(ops.paged_prefill_attention.launches_by_route)
    ops.paged_attention(q, k, v, lens, pt)               # warm, eager
    ops.paged_prefill_attention(q, k, v, cache, vals, pt)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        k2 = ops.paged_attention(q, k, v, lens, pt)
        k1 = ops.paged_prefill_attention(q, k, v, cache, vals, pt)
    assert ops.paged_prefill_attention.launches_by_route["split_mma"] \
        == by_route.get("split_mma", 0) + 2
    rng = np.random.default_rng(7)
    for new in (rng.integers(1, 5001, 16), [1] * 16, [8192] * 16):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        cache.copy_(lens - 1)
        vals.copy_(torch.tensor(rng.integers(0, 2, 16), dtype=torch.int32))
        graph.replay()
        want2 = ops.paged_attention(q, k, v, lens, pt)
        want1 = ops.paged_prefill_attention(q, k, v, cache, vals, pt)
        torch.cuda.synchronize()
        assert torch.equal(k2, want2) and torch.equal(k1, want1)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,npages,span", SPLIT_CELLS)
def test_fp8_split_mma_equals_the_upcast_pools(cuda, hq, hkv, npages, span):
    """e4m3 pools at the cells' heads give the bits of the same call on
    the pools upcast to bf16 (their tiles widened exactly in shared
    memory), K1 and K2 alike."""
    lens = np.random.default_rng(hq + 1).integers(span[0], span[1] + 1, 16)
    q, k, v, lens, pt = _split_inputs(cuda, 16, hq, hkv, 128, 128, npages,
                                      lens.tolist(), seed=hq + 1)
    k8, v8 = _fp8(k, v)
    ku, vu = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
    vals = torch.ones_like(lens)
    assert torch.equal(ops.paged_attention(q, k8, v8, lens, pt),
                       ops.paged_attention(q, ku, vu, lens, pt))
    assert torch.equal(
        ops.paged_prefill_attention(q, k8, v8, lens - 1, vals, pt),
        ops.paged_prefill_attention(q, ku, vu, lens - 1, vals, pt))


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    """The wrapper raises on a CUDA tensor it cannot launch on; it never
    falls back to the plain version."""
    args = [torch.from_numpy(x).to(cuda) for x in case("gqa", 8)]
    before = ops.paged_prefill_attention.launches
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(args[0].half(), args[1].half(),
                                    args[2].half(), *args[3:])
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError):
        ops.paged_prefill_attention(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):     # a page size it has no build for
        k4, v4 = (x.reshape(-1, 4, *x.shape[2:]) for x in args[1:3])
        ops.paged_prefill_attention(args[0], k4, v4, *args[3:])
    assert ops.paged_prefill_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_decode_kernel_matches_plain(cuda, shape, blk, pairing, dtype,
                                           tol):
    """K2: bf16 is one rounding of the f32 result apart; f32 another
    summation order. Against the split walk it runs (TIGHT); equal bits on
    a second call."""
    args = [torch.from_numpy(x).to(cuda)
            for x in decode_case(*shape[:5], blk, shape[5], seed=blk)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    q = args[0][:, None]
    before = ops.paged_attention.launches
    got = ops.paged_attention(q, *args[1:], pairing=pairing)
    again = ops.paged_attention(q, *args[1:], pairing=pairing)
    want = ref.paged_attention_ref(*args, pairing=pairing)
    plan = ops.kernel_plan(q, args[1], args[2], args[4])
    walk = ref.paged_attention_split_ref(
        args[0].float(), args[1].float(), args[2].float(), *args[3:],
        split=plan["split"], pairing=pairing,
        p_dtype=dtype if plan["route"] in TENSOR_CORE_ROUTES else None)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)
    atol, rtol = TIGHT["K2"][dtype]
    torch.testing.assert_close(got[:, 0].float(), walk, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, pairing, dtype, tol):
    """K3 at ragged sq, MQA/GQA and dv != d."""
    b, sq, hq, hkv, d, dv, causal = shape
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in dense_case(b, sq, sq, hq, hkv, d, dv, seed=sq))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, pairing=pairing)
    want = fa_ref.attention_ref(q, k, v, causal=causal, pairing=pairing)
    tiled = fa_ref.attention_tiled_ref(
        q.float(), k.float(), v.float(), causal=causal, pairing=pairing,
        p_dtype=dtype if dtype == torch.bfloat16 else None)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    atol, rtol = TIGHT["K3"][dtype]
    torch.testing.assert_close(got.float(), tiled, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sq,skv", [(1, 150), (5, 150), (70, 150),
                                    (1, 1500), (64, 1500)])
def test_flash_kernel_cross_attention(cuda, sq, skv, dtype, tol):
    """K3 not causal with sq != skv: queries against an encoder's keys
    (whisper-tiny's heads), at a decode step (sq = 1) and over a text;
    skv 1500 is whisper-tiny's encoder length."""
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in dense_case(2, sq, skv, 6, 6, 64, 64, seed=sq))
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa_ref.attention_ref(q, k, v, causal=False)
    tiled = fa_ref.attention_tiled_ref(
        q.float(), k.float(), v.float(), causal=False,
        p_dtype=dtype if dtype == torch.bfloat16 else None)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    atol, rtol = TIGHT["K3"][dtype]
    torch.testing.assert_close(got.float(), tiled, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("shape", DENSE_DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, shape, scalar, pairing, dtype,
                                     tol):
    """K4 with a scalar length and per-row lengths (one row at 1, one at
    S); the same bits on a second call."""
    b, S, hq, hkv, d, dv = shape
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in dense_case(b, 1, S, hq, hkv, d, dv, seed=S))
    lens = np.random.default_rng(S).integers(1, S + 1, size=b)
    lens[0], lens[-1] = 1, S
    kv_len = S // 2 if scalar else torch.from_numpy(
        lens.astype(np.int32)).to(cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, kv_len, pairing=pairing)
    again = da.decode_attention(q, k, v, kv_len, pairing=pairing)
    want = da_ref.decode_attention_ref(q[:, 0], k, v, kv_len,
                                       pairing=pairing)
    split, _ = da.kernel_plan(q, k, v)
    walk = da_ref.decode_attention_split_ref(
        q[:, 0].float(), k.float(), v.float(), kv_len, split=split,
        pairing=pairing)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)
    atol, rtol = TIGHT["K4"][dtype]
    torch.testing.assert_close(got[:, 0].float(), walk, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    """K2, K3 and K4 raise on CUDA tensors they cannot launch on; none
    falls back to its plain version."""
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in dense_case(2, 8, 8, 4, 2, 32, 32, seed=0))
    counts = (fa.flash_attention.launches, da.decode_attention.launches,
              ops.paged_attention.launches)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.transpose(1, 2), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :2].contiguous(), k[..., :2].contiguous(),
                           v[..., :2].contiguous())   # 8-byte rows
    with pytest.raises(TypeError):
        da.decode_attention(q[:, :1].contiguous(), k, v,
                            torch.ones(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, 3)               # two queries a row
    dq, kp, vp, lens, pt = (torch.from_numpy(x).to(cuda) for x in
                            decode_case(2, 4, 2, 32, 32, 8, 3, seed=0))
    with pytest.raises(TypeError):
        ops.paged_attention(dq[:, None], kp, vp, lens.long(), pt)
    assert counts == (fa.flash_attention.launches,
                      da.decode_attention.launches,
                      ops.paged_attention.launches)


# (b, s, h, p, g, n, chunk, with an initial state): mamba2-370m's and
# zamba2-7b's heads over two chunks, a ragged single chunk (L = s = 100),
# two B/C groups, the other head dims, an initial state, and mamba2-370m's
# training step (8 rows of one chunk of 128, an initial state)
SSD_SHAPES = [(1, 512, 4, 64, 1, 128, 256, False),
              (1, 512, 4, 64, 1, 64, 256, False),
              (4, 512, 32, 64, 1, 128, 256, False),    # mamba2-370m prefill
              (1, 512, 112, 64, 1, 64, 256, False),    # zamba2-7b forward
              (2, 100, 4, 64, 1, 128, 256, False),
              (2, 128, 8, 32, 2, 64, 64, False),
              (2, 96, 4, 16, 1, 16, 32, False),
              (1, 128, 2, 128, 1, 64, 64, False),
              (2, 256, 4, 64, 1, 128, 128, True),
              (8, 128, 32, 64, 1, 128, 256, True)]
# bf16: m, w and y are rounded to bf16 at the same points on both sides, and
# a rounding of m flips where the f32 sums before it differ; f32: another
# summation order
SSD_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# (atol, rtol) against the walk the kernels run (ssd_chunked_tiled_ref, y
# before its last rounding, float32): a bf16 y is at most half a bf16 ulp
# (2^-8 relative) from it, moved also by a rounding of M or w that lands the
# other way after another summation order; beyond that, one bf16 ulp of the
# walk's y_diag, whose rounding may land the other way too; the state and
# f32 differ by summation order only
SSD_WALK = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-3, 4e-3)}


def ssd_case(b, s, h, p, g, n, seed, init=False):
    """x, dt, A, B, C (and an initial state) as numpy. x, B and C come as
    slices of one (b, s, h*p + 2*g*n) array, strided along (b, s) as the
    model's conv output hands them over."""
    rng = np.random.default_rng(seed)
    xbc = (rng.standard_normal((b, s, h * p + 2 * g * n)) * 0.5).astype(
        np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32)
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    st = (rng.standard_normal((b, g, h // g, n, p)) * 0.5).astype(np.float32)
    return xbc, dt, A, (st if init else None)


def _ssd_tensors(case, h, p, g, n, dtype, dev):
    xbc, dt, A, st = case
    xbc = torch.from_numpy(xbc).to(dev).to(dtype)
    b, s = xbc.shape[:2]
    x, B, C = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    return (x.unflatten(-1, (h, p)), torch.from_numpy(dt).to(dev),
            torch.from_numpy(A).to(dev), B.unflatten(-1, (g, n)),
            C.unflatten(-1, (g, n)),
            None if st is None else torch.from_numpy(st).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, shape, dtype, tol):
    """K5 reads x, B and C in place as strided views; y and the final
    state against the plain version."""
    b, s, h, p, g, n, chunk, init = shape
    x, dt, A, B, C, st = _ssd_tensors(ssd_case(b, s, h, p, g, n, seed=s,
                                               init=init), h, p, g, n, dtype,
                                      cuda)
    assert not x.is_contiguous()
    before = ssd_ops.ssd.launches
    y, state = ssd_ops.ssd(x, dt, A, B, C, chunk, st)
    want_y, want_state = ssd_ref.ssd_chunked_ref(x, dt, A, B, C, chunk, st)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)
    walk_y, walk_state, y_diag = ssd_ref.ssd_chunked_tiled_ref(
        x, dt, A, B, C, chunk, st, diag=True)
    atol, rtol = SSD_WALK[dtype]
    err = (y.float() - walk_y).abs() - rtol * walk_y.abs() \
        - ssd_ref.ulp(y_diag, dtype)
    assert err.max().item() <= atol
    torch.testing.assert_close(state, walk_state, atol=atol, rtol=rtol)
    y2, state2 = ssd_ops.ssd(x, dt, A, B, C, chunk, st)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,L", [(128, 64, 256), (64, 64, 256),
                                   (16, 16, 8), (48, 32, 100),
                                   (64, 128, 64)])
def test_ssd_plan_matches_the_kernels(cuda, n, p, L):
    """The shared memory ``kernel_plan`` checks is what the kernels ask
    for."""
    for kernel in ("f32", "chunk", "out"):
        assert ssd_ops.built_smem_bytes(kernel, n, p, L) == \
            ssd_ops.smem_bytes(kernel, n, p, L)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    """The wrapper raises on CUDA tensors it cannot launch on; it never
    falls back to the plain version."""
    h, p, g, n = 4, 16, 1, 16
    x, dt, A, B, C, _ = _ssd_tensors(ssd_case(2, 32, h, p, g, n, seed=0),
                                     h, p, g, n, torch.float32, cuda)
    before = ssd_ops.ssd.launches
    with pytest.raises(TypeError):
        ssd_ops.ssd(x.half(), dt, A, B.half(), C.half(), 16)
    with pytest.raises(TypeError):
        ssd_ops.ssd(x, dt.double(), A, B, C, 16)
    with pytest.raises(ValueError):          # x's last dim not contiguous
        ssd_ops.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                    B, C, 16)
    with pytest.raises(ValueError):          # a head dim it has no build for
        ssd_ops.ssd(x[..., :8], dt, A, B, C, 16)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd(x, dt, A, B, C, 24)
    # bf16: x, B and C rows off 16-byte boundaries (the conv output one
    # element wider, sliced from its second element), a d_state off 16
    b, s = 2, 32
    xbc = torch.randn((b, s, h * p + 2 * g * n + 1), device=cuda,
                      dtype=torch.bfloat16)
    parts = torch.split(xbc[..., 1:], [h * p, g * n, g * n], dim=-1)
    xm, Bm, Cm = (parts[0].unflatten(-1, (h, p)),
                  parts[1].unflatten(-1, (g, n)),
                  parts[2].unflatten(-1, (g, n)))
    xa, Ba, Ca = (t.to(torch.bfloat16) for t in (x, B, C))
    for args in ((xm, Ba, Ca), (xa, Bm, Ca), (xa, Ba, Cm)):
        with pytest.raises(ValueError, match="16-byte"):
            ssd_ops.ssd(args[0], dt, A, args[1], args[2], 16)
    with pytest.raises(ValueError, match="d_state"):
        ssd_ops.ssd(xa, dt, A, Ba[..., :8].contiguous(),
                    Ca[..., :8].contiguous(), 16)
    assert ssd_ops.ssd.launches == before


# ------------------------------------------------ the gradients (training)

# max |err| <= tol x the plain gradient's largest magnitude: bf16 takes the
# kernel's rounded output and P rounded to bf16 in its forward; f32 differs
# by summation order
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the first forward shapes, and gemma-2b's training step (8 rows of 128)
GRAD_FLASH_SHAPES = FLASH_SHAPES[:4] + [(2, 128, 8, 1, 256, 256, True),
                                        (8, 128, 8, 1, 256, 256, True)]


def _grads_close(got, want, tol):
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", GRAD_FLASH_SHAPES)
def test_flash_gradient_matches_plain(cuda, shape, pairing, dtype):
    """K3 with an input that requires grad goes through FlashAttentionFn
    (one launch, the lse kept): its output against the plain version, and
    against the walk it runs within TIGHT plus one entry of P rounded the
    other way (``attention_tiled_ref``'s flip slack); dq, dk, dv against
    autograd of the plain version; the lse against the plain one."""
    b, sq, hq, hkv, d, dv, causal = shape
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in dense_case(b, sq, sq, hq, hkv, d, dv, seed=sq + 1))
    do = torch.randn((b, sq, hq, dv), device=cuda).to(dtype)
    kw = dict(causal=causal, pairing=pairing)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.flash_attention.launches
    out = fa.flash_attention(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert fa.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, do)
    assert [g.dtype for g in got] == [dtype] * 3
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = fa_ref.attention_ref(*plain, **kw)
    want = torch.autograd.grad(plain_out, plain, do)
    torch.cuda.synchronize()
    tol = dict(DTYPES)[dtype]
    torch.testing.assert_close(out.detach().float(),
                               plain_out.detach().float(), atol=tol, rtol=tol)
    walk, slack = fa_ref.attention_tiled_ref(
        q.float(), k.float(), v.float(), **kw,
        p_dtype=dtype if dtype == torch.bfloat16 else None, flip_slack=True)
    atol, rtol = TIGHT["K3"][dtype]
    assert ((out.detach().float() - walk).abs()
            <= atol + rtol * walk.abs() + slack).all()
    _grads_close(got, want, GRAD_TOL[dtype])
    o2, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o2, out.detach())
    want_lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES[2:3] + SSD_SHAPES[4:])
def test_ssd_gradient_matches_plain(cuda, shape, dtype):
    """K5 with an input that requires grad goes through SSDFn (one launch):
    y and the final state against the plain version as
    ``test_ssd_kernel_matches_plain`` holds them; the gradients of the conv
    output x, B and C are views of, dt, A and the initial state against
    autograd of the plain version (the backward recomputes the plain
    version, so these check SSDFn's wiring)."""
    b, s, h, p, g, n, chunk, _ = shape
    xbc, dt, A, st = ssd_case(b, s, h, p, g, n, seed=s + 2, init=True)
    ins = [torch.from_numpy(a).to(cuda) for a in (xbc, dt, A, st)]
    ins[0] = ins[0].to(dtype)
    dy = torch.randn((b, s, h, p), device=cuda).to(dtype)
    dst = torch.randn((b, g, h // g, n, p), device=cuda)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        x, B, C = torch.split(leaves[0], [h * p, g * n, g * n], dim=-1)
        y, state = fn(x.unflatten(-1, (h, p)), leaves[1], leaves[2],
                      B.unflatten(-1, (g, n)), C.unflatten(-1, (g, n)),
                      chunk, leaves[3])
        return (y, state), torch.autograd.grad((y, state), leaves,
                                               (dy, dst))

    before = ssd_ops.ssd.launches
    out, got = run(ssd_ops.ssd)
    assert type(out[0].grad_fn).__name__ == "SSDFnBackward"
    assert ssd_ops.ssd.launches == before + 1
    want_out, want = run(ssd_ref.ssd_chunked_ref)
    torch.cuda.synchronize()
    tol = dict(SSD_DTYPES)[dtype]
    for o, w in zip(out, want_out):
        torch.testing.assert_close(o.detach().float(), w.detach().float(),
                                   atol=tol, rtol=tol)
    _grads_close(got, want, GRAD_TOL[dtype])


GRAD_ARCHS = ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b",
              "whisper-tiny"]


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_model_gradients_on_the_card_equal_the_cpu(cuda, arch, policy):
    """The smoke model's loss and every gradient leaf at f32 on the card
    (K3 and K5 through their Functions) against the CPU's (the plain
    versions under autograd), from the same params and batch, under
    either ``remat_policy``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import backward as fa_bwd
    from repro_torch.kernels.ssd import backward as ssd_bwd
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves, tree_map
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         remat_policy=policy)
    model = build(cfg)
    params = model.init_train_params(seed=0, device="cpu")
    batch = SyntheticLM(cfg, 2, 16, seed=1, device="cpu").batch_at(0)
    (want, _), want_g = value_and_grad(model.loss)(params, batch)
    calls = (fa_bwd.flash_attention_backward.calls,
             ssd_bwd.ssd_backward.calls)
    (got, _), got_g = value_and_grad(model.loss)(
        tree_map(lambda t: t.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    ran = (fa_bwd.flash_attention_backward.calls > calls[0],
           ssd_bwd.ssd_backward.calls > calls[1])
    assert ran == (cfg.family != "ssm", cfg.ssm is not None)
    assert abs(got.item() - want.item()) <= 1e-5
    for g, w in zip(leaves(got_g), leaves(want_g)):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * max(1.0, w.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,leaf", [("gemma-2b", ("attn", "wq")),
                                       ("gemma-2b", ("attn", "wk")),
                                       ("gemma-2b", ("attn", "wv")),
                                       ("mamba2-370m", ("mamba", "in_proj"))])
def test_gradients_reach_before_the_kernels(cuda, arch, leaf):
    """bf16 on the card: every layer's slice of what feeds K3 (wq, wk, wv)
    or K5 (the Mamba block's in_proj) gets a finite, non-zero gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init_train_params(seed=0, device=cuda)
    batch = SyntheticLM(cfg, 2, 16, seed=1, device=cuda).batch_at(0)
    _, grads = value_and_grad(model.loss)(params, batch)
    g = grads["layers"][leaf[0]][leaf[1]]
    assert g.shape[0] == cfg.n_layers
    for layer in g:
        assert torch.isfinite(layer).all() and layer.abs().max() > 0


@pytest.mark.gpu
def test_tp_megastep_on_the_card(cuda):
    """The tensor-parallel megastep, every shard on the card, bf16: tp 1
    equals the mesh-less megastep bit for bit (tokens and pools, the null
    block excluded); tp 2 launches K1 once per shard per layer and
    serves the same schedule to the end."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import PagedInferenceEngine
    cfg = get_smoke_config("gemma-2b").replace(
        remat=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256)
    params = init_params(cfg, seed=0, device=cuda)
    kw = dict(num_blocks=65, block_size=8, max_batch=4, max_len=96,
              prefill_chunk=16, token_budget=16)

    def run(tp):
        mesh = make_tp_mesh(tp, devices=[cuda] * tp) if tp else None
        eng = PagedInferenceEngine(cfg, params, mesh=mesh, device=cuda,
                                   **kw)
        eng.compile_buckets()
        before = ops.paged_prefill_attention.launches
        rid = eng.submit(np.arange(1, 20), max_new_tokens=8, retain=True)
        eng.run_to_completion()
        eng.extend(rid, np.arange(30, 38), max_new_tokens=8)
        eng.run_to_completion()
        eng.sync()
        launches = ops.paged_prefill_attention.launches - before
        assert launches == cfg.n_layers * max(tp, 1) * eng.steps_dispatched
        assert eng.jit_dispatches_per_step == 1.0
        return eng, list(eng.reqs[rid].out_tokens)

    base, want = run(0)
    one, got = run(1)
    assert got == want
    for a, b in zip(one.cache.full_pools(), base.cache.full_pools()):
        assert torch.equal(a[:, 1:], b[:, 1:])
    two, toks = run(2)
    assert len(toks) == 8 and min(toks) >= 0


# ------------------------------------------------- the compiled dispatch

def _graph_model(cuda, dtype="float32"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_params
    cfg = get_smoke_config("gemma-2b").replace(
        remat=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, compute_dtype=dtype)
    return cfg, init_params(cfg, seed=0, device=cuda)


GRAPH_KW = dict(num_blocks=65, block_size=8, max_batch=4, max_len=96,
                prefill_chunk=16, token_budget=16)


def _graph_traffic(eng, rebind=False):
    """Three prompts, the second released mid-turn and a late one taking
    its slot, then an extend of the first; ``rebind`` swaps the pools for
    copies (``set_pools``) after the third step. Returns the tokens."""
    rids = [eng.submit(np.arange(1 + i, 20 + 7 * i) % 256,
                       max_new_tokens=6, retain=i == 0) for i in range(3)]
    for _ in range(3):
        eng.step()
    if rebind:
        eng.cache.set_pools([{n: t.clone() for n, t in s.items()}
                             for s in eng.cache.pools()])
    eng.release(rids[1])
    rids[1] = eng.submit(np.arange(40, 52), max_new_tokens=5)
    out = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
    eng.extend(rids[0], np.arange(30, 38), max_new_tokens=6)
    eng.run_to_completion()
    out[rids[0]] += list(eng.reqs[rids[0]].out_tokens)
    eng.sync()
    return [out[r] for r in rids]


@pytest.mark.gpu
@pytest.mark.parametrize("rebind", [False, True])
@pytest.mark.parametrize("tp", [0, 1, 2])
def test_graph_replay_equals_eager_step(cuda, tp, rebind):
    """f32: the megastep replayed from its graphs (every bucket captured
    by compile_buckets; after ``set_pools`` recaptured at first use) gives
    the eager step's tokens and pools bit for bit, without a mesh and at
    tp 1 and 2 on the one card; one replay per step; the same K1
    launches."""
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.serving import PagedInferenceEngine
    cfg, params = _graph_model(cuda)
    runs = {}
    for graphs_on in (False, True):
        mesh = make_tp_mesh(tp, devices=[cuda] * tp) if tp else None
        eng = PagedInferenceEngine(cfg, params, mesh=mesh, device=cuda,
                                   cuda_graphs=graphs_on, **GRAPH_KW)
        eng.compile_buckets()
        before = ops.paged_prefill_attention.launches
        toks = _graph_traffic(eng, rebind)
        launches = ops.paged_prefill_attention.launches - before
        assert launches == cfg.n_layers * max(tp, 1) * eng.steps_dispatched
        assert eng.jit_dispatches_per_step == 1.0
        runs[graphs_on] = eng, toks, launches
    (eager, want, n_eager), (graph, got, n_graph) = runs[False], runs[True]
    assert got == want and n_graph == n_eager
    for a, b in zip(graph.cache.full_pools(), eager.cache.full_pools()):
        assert torch.equal(a[:, 1:], b[:, 1:])
    st = graph.graph_stats()
    n_buckets = len(graph.bucket_set)
    if rebind:
        # the rebind dropped every graph; each width met after it was
        # captured at its first call, whose step ran eagerly
        assert st["first_calls"] > n_buckets
    else:
        assert st["first_calls"] == n_buckets
    assert st["replays"] + st["first_calls"] == \
        graph.steps_dispatched + n_buckets


@pytest.mark.gpu
def test_flat_bucket_replay_equals_eager(cuda):
    """bf16: the buckets 8 and 16 of a budget of 16 over 4 rows run their
    dense layers on 16 flat slots (their K1 on the (4, C) batch); replayed
    from their graphs they give the eager step's tokens and pools bit for
    bit, the null block excluded, as at f32 above."""
    from repro_torch.serving import PagedInferenceEngine
    cfg, params = _graph_model(cuda, "bfloat16")
    runs = {}
    for graphs_on in (False, True):
        eng = PagedInferenceEngine(cfg, params, device=cuda,
                                   cuda_graphs=graphs_on, **GRAPH_KW)
        eng.compile_buckets()
        toks = _graph_traffic(eng)
        assert eng.flat_width == {1: 4, 8: 16, 16: 16}
        assert eng.step_stats()["flat_steps"] > 0
        runs[graphs_on] = eng, toks
    (eager, want), (graph, got) = runs[False], runs[True]
    assert got == want
    assert graph.step_stats()["flat_steps"] == \
        eager.step_stats()["flat_steps"]
    for a, b in zip(graph.cache.full_pools(), eager.cache.full_pools()):
        assert torch.equal(a[:, 1:], b[:, 1:])
    assert graph.graph_stats()["first_calls"] == len(graph.bucket_set)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compile_buckets_counts_k1_by_route(cuda, dtype):
    """Each bucket's warm-up and capture count K1 under its route, one
    launch a layer each: the decode bucket (C = 1) under "split_mma" in
    bf16 and "split" in f32, the others under "tensor_cores" / "walk";
    replays add to ``launches`` only."""
    from repro_torch.serving import PagedInferenceEngine
    cfg, params = _graph_model(cuda, dtype)
    eng = PagedInferenceEngine(cfg, params, device=cuda, cuda_graphs=True,
                               **GRAPH_KW)
    before = dict(ops.paged_prefill_attention.launches_by_route)
    eng.compile_buckets()
    grew = {r: n - before.get(r, 0) for r, n in
            ops.paged_prefill_attention.launches_by_route.items()
            if n != before.get(r, 0)}
    decode, wide = (("split_mma", "tensor_cores") if dtype == "bfloat16"
                    else ("split", "walk"))
    per_bucket = 2 * cfg.n_layers                  # warm-up, then capture
    assert grew == {decode: per_bucket,
                    wide: per_bucket * (len(eng.bucket_set) - 1)}
    after = dict(ops.paged_prefill_attention.launches_by_route)
    _graph_traffic(eng)
    assert ops.paged_prefill_attention.launches_by_route == after


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["legacy", "dense"])
def test_graph_decode_launches_per_replay(cuda, engine, dtype):
    """The legacy loop's decode (K2) and the dense engine's (K4), each
    captured at its first call: the eager engine's tokens (and at f32 its
    pools or cache bit for bit), K2 / K4 launched n_layers times a decode
    step, every decode after the first a replay."""
    from repro_torch.serving import InferenceEngine, PagedInferenceEngine
    cfg, params = _graph_model(cuda, dtype)
    prompts = [np.arange(1 + i, 20 + 7 * i) % 256 for i in range(5)]
    wrapper = ops.paged_attention if engine == "legacy" \
        else da.decode_attention
    runs = {}
    for graphs_on in (False, True):
        if engine == "legacy":
            eng = PagedInferenceEngine(cfg, params, device=cuda,
                                       megastep=False, cuda_graphs=graphs_on,
                                       **GRAPH_KW)
        else:
            eng = InferenceEngine(cfg, params, max_slots=2, max_len=96,
                                  device=cuda, cuda_graphs=graphs_on)
        before = wrapper.launches
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
        eng.sync()
        decodes = eng.decode_steps if engine == "legacy" \
            else eng.steps_dispatched
        assert wrapper.launches - before == cfg.n_layers * decodes
        state = ([t for s in eng.cache.pools() for t in s.values()]
                 if engine == "legacy" else list(eng.state.values()))
        runs[graphs_on] = [done[r] for r in rids], state, eng
    assert runs[True][0] == runs[False][0]
    if dtype == "float32":
        for a, b in zip(runs[True][1], runs[False][1]):
            assert torch.equal(a, b)
    eng = runs[True][2]
    st = eng.graph_stats()
    decodes = eng.decode_steps if engine == "legacy" \
        else eng.steps_dispatched
    # the decode, and the chunks (one width) or prefills (one graph per
    # prompt length), each captured at its first call
    prefills = eng.jit_dispatches - decodes
    keys = set(eng.graphs.steps)
    assert "decode" in keys and st["first_calls"] == len(keys)
    assert st["replays"] == decodes + prefills - len(keys)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["legacy", "dense"])
def test_graph_prefills_replay_equal_eager(cuda, engine, dtype):
    """The legacy loop's chunked prefill (K1, one graph per chunk width,
    its lengths staged on the device) and the dense engine's prefill (K3,
    one graph per prompt length, copied in at the staged slot), replayed
    for prompts of repeated lengths: the eager engine's tokens (at f32 its
    pools or cache bit for bit) and launches."""
    from repro_torch.serving import InferenceEngine, PagedInferenceEngine
    cfg, params = _graph_model(cuda, dtype)
    prompts = [np.arange(1 + i, 1 + i + (40 if i % 2 else 23)) % 256
               for i in range(6)]
    wrapper = ops.paged_prefill_attention if engine == "legacy" \
        else fa.flash_attention
    runs = {}
    for graphs_on in (False, True):
        if engine == "legacy":
            eng = PagedInferenceEngine(cfg, params, device=cuda,
                                       megastep=False, cuda_graphs=graphs_on,
                                       **GRAPH_KW)
        else:
            eng = InferenceEngine(cfg, params, max_slots=2, max_len=96,
                                  device=cuda, cuda_graphs=graphs_on)
        before = wrapper.launches
        rids = [eng.submit(p, max_new_tokens=3 + i % 3)
                for i, p in enumerate(prompts)]
        done = {r.rid: list(r.out_tokens) for r in eng.run_to_completion()}
        eng.sync()
        decodes = eng.decode_steps if engine == "legacy" \
            else eng.steps_dispatched
        prefills = eng.jit_dispatches - decodes
        assert wrapper.launches - before == cfg.n_layers * prefills
        state = ([t for s in eng.cache.pools() for t in s.values()]
                 if engine == "legacy" else list(eng.state.values()))
        runs[graphs_on] = [done[r] for r in rids], state, eng, prefills
    assert runs[True][0] == runs[False][0]
    assert runs[True][3] == runs[False][3]
    if dtype == "float32":
        for a, b in zip(runs[True][1], runs[False][1]):
            assert torch.equal(a, b)
    eng, prefills = runs[True][2], runs[True][3]
    keys = set(eng.graphs.steps) - {"decode"}
    assert keys == ({("chunk", GRAPH_KW["prefill_chunk"])}
                    if engine == "legacy" else {("prefill", 23),
                                                ("prefill", 40)})
    assert prefills > len(keys)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m"])
def test_captured_train_step_equals_eager_on_the_card(cuda, arch, policy,
                                                      monkeypatch):
    """The smoke model's train step (bf16 compute, K3 or K5 through its
    Function, remat under either ``remat_policy``, clip, AdamW),
    deterministic: three steps replayed from one CUDA graph against three
    eager steps from the same params, metrics and params and optimizer
    state bit for bit, the kernel's launches equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import make_train_step
    from repro_torch.tree import leaves
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_smoke_config(arch).replace(remat_policy=policy)
    model = build(cfg)
    ocfg = opt.AdamWConfig()
    data = SyntheticLM(cfg, 2, 16, seed=1, device=cuda)
    wrapper = ssd_ops.ssd if cfg.family == "ssm" else fa.flash_attention
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        for graphs_on in (False, True):
            params = model.init_train_params(seed=0, device=cuda)
            state = opt.init(params, ocfg)
            step = make_train_step(cfg, ocfg, cuda_graphs=graphs_on)
            before = wrapper.launches
            metrics = []
            for i in range(3):
                params, state, m = step(params, state, data.batch_at(i))
                metrics.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            runs[graphs_on] = (params, state, metrics,
                               wrapper.launches - before, step)
    finally:
        torch.use_deterministic_algorithms(was)
    (pe, se, me, ne, _), (pg, sg, mg, ng, step) = runs[False], runs[True]
    assert ng == ne == (2 if cfg.remat else 1) * cfg.n_layers * 3
    for a, b in zip(mg, me):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    for x, y in zip(leaves((pg, sg)), leaves((pe, se))):
        assert torch.equal(x, y)
    st = step.graph_stats()
    assert st["first_calls"] == 1 and st["replays"] == 2


# ------------------------------------------------------ the fp8 KV cache

FP8 = torch.float8_e4m3fn


def _fp8(*xs):
    """Tensors cast to e4m3 as the cache writes cast them."""
    from repro_torch.device import cast_to
    return [cast_to(x, FP8) for x in xs]


def _same_bits(a, b):
    return torch.equal(a.view(torch.uint8) if a.dtype == FP8 else a,
                       b.view(torch.uint8) if b.dtype == FP8 else b)


# K1's routes on e4m3 pools: the walk (f32, C > 1), the split decode
# (C = 1) and the tensor-core tiles (bf16, C > 1; gemma-2b's exact build at
# d = 256, the others' at d 32 / 64 / 128)
FP8_K1 = [(s, C, dt) for s, C in CASES for dt in (torch.float32,
                                                  torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape,C,dtype", FP8_K1 + [
    (("gemma", b, C, npages), C, torch.bfloat16)
    for b, C, npages in GEMMA_PAGED] + [
    (("odd", hq, hkv), C, torch.bfloat16) for hq, hkv in ODD_GROUPS[:2]
    for C in (1, 32)])
def test_fp8_k1_equals_the_upcast_pools(cuda, shape, C, dtype, pairing):
    """Each route on e4m3 pools gives the bits of the same kernel on the
    pools upcast to q's dtype (the plan, the units and every product are
    that call's), and lies within the bf16 / f32 tolerance of the plain
    version; one launch counted per call."""
    if shape[0] == "gemma":
        x = mixed_case(shape[1], C, 8, 1, 256, 256, 16, shape[3],
                       seed=shape[1] + C)
    elif shape[0] == "odd":
        x = mixed_case(4, C, shape[1], shape[2], 128, 128, 16, 8,
                       seed=shape[1] + C)
    else:
        x = case(shape, C)
    q, k, v, lens, vals, pt = (torch.from_numpy(a).to(cuda) for a in x)
    q = q.to(dtype)
    k8, v8 = _fp8(k, v)
    before = ops.paged_prefill_attention.launches
    got = ops.paged_prefill_attention(q, k8, v8, lens, vals, pt,
                                      pairing=pairing)
    up = ops.paged_prefill_attention(q, k8.to(dtype), v8.to(dtype), lens,
                                     vals, pt, pairing=pairing)
    want = ref.paged_prefill_attention_ref(q, k8, v8, lens, vals, pt,
                                           pairing=pairing)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 2
    assert ops.kernel_plan(q, k8, v8, pt) == ops.kernel_plan(
        q, k8.to(dtype), v8.to(dtype), pt)
    assert torch.equal(got, up)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_fp8_k2_equals_the_upcast_pools(cuda, shape, blk, dtype):
    q, k, v, lens, pt = (torch.from_numpy(x).to(cuda)
                         for x in decode_case(*shape[:5], blk, shape[5],
                                              seed=blk))
    q = q[:, None].to(dtype)
    k8, v8 = _fp8(k, v)
    got = ops.paged_attention(q, k8, v8, lens, pt, pairing="g_major")
    up = ops.paged_attention(q, k8.to(dtype), v8.to(dtype), lens, pt,
                             pairing="g_major")
    want = ref.paged_attention_ref(q[:, 0], k8, v8, lens, pt,
                                   pairing="g_major")
    torch.cuda.synchronize()
    assert torch.equal(got, up)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("shape", DENSE_DECODE_SHAPES)
def test_fp8_k4_equals_the_upcast_cache(cuda, shape, scalar, dtype):
    b, S, hq, hkv, d, dv = shape
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in dense_case(b, 1, S, hq, hkv, d, dv, seed=S))
    q = q.to(dtype)
    k8, v8 = _fp8(k, v)
    lens = np.random.default_rng(S).integers(1, S + 1, size=b)
    lens[0], lens[-1] = 1, S
    kv_len = S // 2 if scalar else torch.from_numpy(
        lens.astype(np.int32)).to(cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k8, v8, kv_len, pairing="g_major")
    up = da.decode_attention(q, k8.to(dtype), v8.to(dtype), kv_len,
                             pairing="g_major")
    want = da_ref.decode_attention_ref(q[:, 0], k8, v8, kv_len,
                                       pairing="g_major")
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    assert torch.equal(got, up)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_fp8_kernels_refuse_what_they_do_not_take(cuda):
    """fp8 q, K and V of two dtypes, and fp8 rows that are not whole
    16-byte chunks (d = 8) raise; nothing launches, nothing falls back."""
    q, k, v, lens, vals, pt = (torch.from_numpy(x).to(cuda)
                               for x in case("gqa", 8))
    k8, v8 = _fp8(k, v)
    counts = (ops.paged_prefill_attention.launches,
              da.decode_attention.launches)
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(*_fp8(q), k8, v8, lens, vals, pt)
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(q, k8, v, lens, vals, pt)
    with pytest.raises(ValueError):
        ops.paged_prefill_attention(
            q[..., :8].contiguous(), k8[..., :8].contiguous(),
            v8[..., :8].contiguous(), lens, vals, pt)
    dq, dk, dv_ = (torch.from_numpy(x).to(cuda)
                   for x in dense_case(2, 1, 8, 4, 2, 32, 32, seed=0))
    with pytest.raises(TypeError):
        da.decode_attention(dq, *_fp8(dk), dv_, 3)
    assert counts == (ops.paged_prefill_attention.launches,
                      da.decode_attention.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_graph_replay_equals_eager_step(cuda, dtype):
    """The megastep on e4m3 pools replayed from its graphs gives the eager
    step's tokens and pools bit for bit; the pools hold half the bytes of
    the compute dtype's."""
    from repro_torch.serving import PagedInferenceEngine
    cfg, params = _graph_model(cuda, dtype)
    cfg = cfg.replace(kv_cache_dtype="float8_e4m3fn")
    runs = {}
    for graphs_on in (False, True):
        eng = PagedInferenceEngine(cfg, params, device=cuda,
                                   cuda_graphs=graphs_on, **GRAPH_KW)
        eng.compile_buckets()
        runs[graphs_on] = eng, _graph_traffic(eng)
    (eager, want), (graph, got) = runs[False], runs[True]
    assert got == want
    for a, b in zip(graph.cache.full_pools(), eager.cache.full_pools()):
        assert a.dtype == FP8 and _same_bits(a[:, 1:], b[:, 1:])
    assert graph.cache.block_bytes * (4 if dtype == "float32" else 2) == \
        PagedInferenceEngine(cfg.replace(kv_cache_dtype=""), params,
                             device=cuda, cuda_graphs=False,
                             **GRAPH_KW).cache.block_bytes
    assert graph.graph_stats()["replays"] > 0
