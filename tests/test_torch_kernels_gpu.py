"""The port's CUDA kernels against their plain PyTorch versions on the card:
K1 (paged chunked prefill), K2 (paged decode), K3 (flash attention), K4
(decode over a contiguous cache) and K5 (the Mamba-2 SSD chunked scan).

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
# (b, sq, hq, hkv, d, dv, causal): ragged sq, MQA, GQA, dv != d, and
# zamba2-7b's heads (d = 112, g = 1)
FLASH_SHAPES = [(2, 33, 4, 2, 64, 64, True), (1, 96, 8, 1, 256, 256, True),
                (2, 40, 4, 1, 64, 32, False), (1, 7, 6, 6, 32, 32, True),
                (1, 130, 4, 2, 128, 128, True),
                (1, 130, 4, 4, 112, 112, True)]
# (b, S, hq, hkv, d, dv); S = 1003 lies off every split, with a row of
# length 1 in it
DENSE_DECODE_SHAPES = [(4, 100, 8, 1, 256, 256), (2, 64, 4, 2, 32, 32),
                       (3, 48, 4, 4, 64, 32), (2, 1003, 8, 2, 64, 64)]
DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]
# Against the plain versions that walk as the kernels do (the tiled flash
# walk with P rounded to bf16, the split-K decode from the kernel's plan),
# in float32 out: bf16 outputs are one rounding apart, at most half a bf16
# ulp (2^-8 relative); K3 also flips a rare rounding of P.
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


def _k1_walk(args, pairing):
    """The walk K1 runs for these CUDA tensors (its plan's key ranges; P
    rounded to bf16 on the tensor cores), in float32."""
    q, k, v, lens, vals, pt = args
    plan = ops.kernel_plan(q, k, v, pt)
    return ref.paged_prefill_attention_tiled_ref(
        q.float(), k.float(), v.float(), lens, vals, pt,
        split=plan["split"], pairing=pairing,
        p_dtype=q.dtype if plan["route"] == "tensor_cores" else None)


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
    assert plan["route"] == ("split" if C == 1 else "tensor_cores")
    _check_k1(args, pairing, torch.bfloat16, 1e-2)


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
    split = ops.kernel_plan(q, args[1], args[2], args[4])["split"]
    walk = ref.paged_attention_split_ref(
        args[0].float(), args[1].float(), args[2].float(), *args[3:],
        split=split, pairing=pairing)
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
# two B/C groups, the other head dims, an initial state
SSD_SHAPES = [(1, 512, 4, 64, 1, 128, 256, False),
              (1, 512, 4, 64, 1, 64, 256, False),
              (4, 512, 32, 64, 1, 128, 256, False),    # mamba2-370m prefill
              (1, 512, 112, 64, 1, 64, 256, False),    # zamba2-7b forward
              (2, 100, 4, 64, 1, 128, 256, False),
              (2, 128, 8, 32, 2, 64, 64, False),
              (2, 96, 4, 16, 1, 16, 32, False),
              (1, 128, 2, 128, 1, 64, 64, False),
              (2, 256, 4, 64, 1, 128, 128, True)]
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
