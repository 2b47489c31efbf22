"""The port's CUDA kernels against their plain PyTorch versions on the card:
K1 (paged chunked prefill), K2 (paged decode), K3 (flash attention) and K4
(decode over a contiguous cache).

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
# (b, sq, hq, hkv, d, dv, causal): ragged sq, MQA, GQA, dv != d
FLASH_SHAPES = [(2, 33, 4, 2, 64, 64, True), (1, 96, 8, 1, 256, 256, True),
                (2, 40, 4, 1, 64, 32, False), (1, 7, 6, 6, 32, 32, True),
                (1, 130, 4, 2, 128, 128, True)]
# (b, S, hq, hkv, d, dv)
DENSE_DECODE_SHAPES = [(4, 100, 8, 1, 256, 256), (2, 64, 4, 2, 32, 32),
                       (3, 48, 4, 4, 64, 32)]
DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape,C", CASES)
def test_cuda_kernel_matches_plain(cuda, shape, C, pairing, dtype, tol):
    """bf16: one bf16 rounding apart at outputs below ~1.5; f32: another
    summation order. The gathered-view twin is equal bit for bit."""
    args = [torch.from_numpy(x).to(cuda) for x in case(shape, C)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    before = ops.paged_prefill_attention.launches
    got = ops.paged_prefill_attention(*args, pairing=pairing)
    want = ref.paged_prefill_attention_ref(*args, pairing=pairing)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    q, k, v, lens, vals, pt = args
    twin = ops.paged_prefill_attention_contig(
        q, ref.gather_pages(k, pt), ref.gather_pages(v, pt), lens, vals, pt,
        pairing=pairing)
    assert torch.equal(got, twin)


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
    summation order."""
    args = [torch.from_numpy(x).to(cuda)
            for x in decode_case(*shape[:5], blk, shape[5], seed=blk)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    q = args[0][:, None]
    before = ops.paged_attention.launches
    got = ops.paged_attention(q, *args[1:], pairing=pairing)
    want = ref.paged_attention_ref(*args, pairing=pairing)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 1
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)


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
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("shape", DENSE_DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, shape, scalar, pairing, dtype,
                                     tol):
    """K4 with a scalar length and per-row lengths (one row at 1, one at
    S)."""
    b, S, hq, hkv, d, dv = shape
    q, k, v = (torch.from_numpy(x).to(cuda).to(dtype)
               for x in dense_case(b, 1, S, hq, hkv, d, dv, seed=S))
    lens = np.random.default_rng(S).integers(1, S + 1, size=b)
    lens[0], lens[-1] = 1, S
    kv_len = S // 2 if scalar else torch.from_numpy(
        lens.astype(np.int32)).to(cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, kv_len, pairing=pairing)
    want = da_ref.decode_attention_ref(q[:, 0], k, v, kv_len,
                                       pairing=pairing)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(got[:, 0].float(), want.float(), atol=tol,
                               rtol=tol)


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
