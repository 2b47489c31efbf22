"""The algorithms of the redesigned K3 and K4, in plain PyTorch on the CPU.

``attention_tiled_ref`` walks flash attention as the bf16 tensor-core
kernel does (64-row M tiles of query positions x the heads of one kv head,
key tiles up to the diagonal, an online softmax, P rounded before P.V);
``decode_attention_split_ref`` computes the split-K decode's per-range
partials and their merge from ``split_plan``. Both are held to the plain
versions (``attention_ref``, ``decode_attention_ref``) and to the Pallas
kernels in interpret mode: float32 within 1e-5 (another summation order);
bf16 within 2e-2 against Pallas and 1e-2 against the plain versions (one
bf16 rounding of the output, plus P rounded to bf16 in the tiled walk,
which moves outputs by up to ~4e-3 here). Inputs are numpy arrays from
seeds, handed to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_bhd
from repro.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_tiled_ref,
                                                     key_tile)
from test_torch_kernels_gpu import dense_case

BF16 = torch.bfloat16


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, tol):
    if torch.is_tensor(want):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------ K3: the tensor-core walk

# (b, sq, hq, hkv, d, dv): ragged sq (several M tiles, a partial last one),
# g in {1, 2, 8}, dv != d, head widths off the multiples of 16
TILED_SHAPES = [(2, 33, 4, 2, 64, 64), (1, 130, 4, 4, 112, 112),
                (2, 40, 8, 1, 32, 16), (1, 7, 6, 6, 32, 32),
                (2, 70, 4, 4, 40, 24), (1, 20, 8, 1, 256, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_ref_matches_plain(shape, pairing, causal):
    b, sq, hq, hkv, d, dv = shape
    q, k, v = _t(dense_case(b, sq, sq, hq, hkv, d, dv, seed=sq + d))
    want = attention_ref(q, k, v, causal=causal, pairing=pairing)
    got = attention_tiled_ref(q, k, v, causal=causal, pairing=pairing)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_ref_bf16_with_p_rounded(shape, pairing):
    """bf16 inputs, P rounded to bf16 before P.V as the kernel does,
    against the plain version in bf16 (1e-2), and against the same walk
    with P unrounded (P's rounding alone, within 1e-2)."""
    b, sq, hq, hkv, d, dv = shape
    q, k, v = _t(dense_case(b, sq, sq, hq, hkv, d, dv, seed=sq + d), BF16)
    got = attention_tiled_ref(q, k, v, pairing=pairing, p_dtype=BF16)
    assert got.dtype == BF16
    _close(got, attention_ref(q, k, v, pairing=pairing), 1e-2)
    exact = attention_tiled_ref(q.float(), k.float(), v.float(),
                                pairing=pairing)
    _close(attention_tiled_ref(q.float(), k.float(), v.float(),
                               pairing=pairing, p_dtype=BF16), exact, 1e-2)


@pytest.mark.parametrize("b,sq,hq,hkv,d,dv,causal", [
    (1, 256, 8, 1, 64, 64, True),       # g = 8: 8 positions per M tile
    (2, 128, 4, 2, 64, 32, False),      # g = 2, dv != d
    (1, 128, 4, 4, 32, 32, True),       # g = 1
    (1, 128, 4, 1, 256, 256, True),     # key tiles of 32
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_tiled_ref_matches_pallas(b, sq, hq, hkv, d, dv, causal, dtype,
                                  tol):
    arrays = dense_case(b, sq, sq, hq, hkv, d, dv, seed=hq + d)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    want = flash_attention(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                           interpret=True)
    q, k, v = _t(arrays, td)
    got = attention_tiled_ref(q, k, v, causal=causal,
                              p_dtype=td if td == BF16 else None)
    _close(got, want, tol)


def test_key_tile_and_grid():
    """64-key tiles up to 128-wide heads, 32 above; the grid packs
    positions x heads of one kv head into 64-row blocks."""
    assert key_tile(112, 112) == key_tile(128, 128) == 64
    assert key_tile(256, 256) == key_tile(192, 128) == 32
    hybrid = fa.launch_grid(1, 512, 32, 32, 112, 112, BF16)
    assert hybrid["grid"] == [8, 32, 1] and hybrid["block_n"] == 64
    gemma = fa.launch_grid(1, 96, 8, 1, 256, 256, BF16)
    assert gemma["grid"] == [12, 1, 1] and gemma["block_n"] == 32
    assert fa.launch_grid(1, 96, 8, 1, 256, 256, torch.float32)["grid"] \
        == [96, 1, 1]


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
def test_tiled_ref_flip_slack(pairing):
    """``flip_slack`` leaves the walk's output as it is and adds, per
    element, what one entry of P rounded to bf16 the other way moves it:
    max_j ulp(P_ij) |v_jc| / l_i (one key tile here, so P is the row's
    softmax numerator), brute-forced over every j; 0 with P unrounded. A
    second case (d 256: 32-key tiles, 40 positions) carries it across key
    tiles: the output unchanged, the slack positive everywhere."""
    b, sq, hq, hkv, d, dv = 1, 9, 4, 2, 16, 8
    q, k, v = _t(dense_case(b, sq, sq, hq, hkv, d, dv, seed=11))
    kw = dict(causal=True, pairing=pairing)
    plain = attention_tiled_ref(q, k, v, p_dtype=BF16, **kw)
    out, slack = attention_tiled_ref(q, k, v, p_dtype=BF16, flip_slack=True,
                                     **kw)
    assert torch.equal(out, plain) and slack.shape == out.shape
    _, zero = attention_tiled_ref(q, k, v, flip_slack=True, **kw)
    assert not zero.any()
    g = hq // hkv
    c = torch.tensor(torch.tensor(d, dtype=torch.float64).rsqrt().item()
                     * np.log2(np.e), dtype=torch.float32)
    for pos in range(sq):
        for h in range(hq):
            kvh = h % hkv if pairing == "g_major" else h // g
            sc = (q[0, pos, h] @ k[0, :pos + 1, kvh].T) * c
            pw = torch.exp2(sc - sc.max())
            pb = pw.to(BF16).float()
            _, e = torch.frexp(pb)
            u = torch.ldexp(torch.ones_like(pb), e - 8)
            vv = v[0, :pos + 1, kvh]
            want = (u[:, None] * vv.abs()).amax(0) / pw.sum()
            torch.testing.assert_close(slack[0, pos, h], want, rtol=1e-5,
                                       atol=0)
            for j in range(pos + 1):
                for step in (u[j], -u[j]):
                    alt = pb.clone()
                    alt[j] += step
                    moved = ((alt - pb) @ vv / pw.sum()).abs()
                    assert (moved <= want * (1 + 1e-5)).all()
    q, k, v = _t(dense_case(1, 40, 40, 2, 1, 256, 16, seed=12))
    out, slack = attention_tiled_ref(q, k, v, p_dtype=BF16, flip_slack=True,
                                     **kw)
    assert torch.equal(out, attention_tiled_ref(q, k, v, p_dtype=BF16, **kw))
    assert (slack > 0).all()


# --------------------------------------------- K4: the split-K decode walk

# (b, S, hq, hkv, d, dv, lens): a row of length 1 in a long cache, a full
# row, ranges wholly past the length, g in {1, 2, 8}, dv != d
SPLIT_SHAPES = [(3, 100, 8, 1, 64, 64, (1, 37, 100)),
                (2, 64, 4, 2, 32, 16, (64, 5)),
                (2, 75, 4, 4, 32, 32, (1, 75)),
                (1, 96, 2, 2, 256, 256, (33,))]


@pytest.mark.parametrize("split", [16, 32, None])    # None: S, one range
@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_ref_matches_plain(shape, pairing, split):
    b, S, hq, hkv, d, dv, lens = shape
    q, k, v = _t(dense_case(b, 1, S, hq, hkv, d, dv, seed=S + hq))
    lens = torch.tensor(lens, dtype=torch.int32)
    want = decode_attention_ref(q[:, 0], k, v, lens, pairing=pairing)
    got = decode_attention_split_ref(q[:, 0], k, v, lens, split=split or S,
                                     pairing=pairing)
    _close(got, want, 1e-5)
    # one length for every row, as the lockstep decode passes it
    want = decode_attention_ref(q[:, 0], k, v, int(lens[-1]),
                                pairing=pairing)
    got = decode_attention_split_ref(q[:, 0], k, v, int(lens[-1]),
                                     split=split or S, pairing=pairing)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_ref_bf16(shape):
    """bf16 inputs, f32 math: one rounding of the output apart."""
    b, S, hq, hkv, d, dv, lens = shape
    q, k, v = _t(dense_case(b, 1, S, hq, hkv, d, dv, seed=S + hq), BF16)
    lens = torch.tensor(lens, dtype=torch.int32)
    got = decode_attention_split_ref(q[:, 0], k, v, lens, split=16)
    assert got.dtype == BF16
    _close(got, decode_attention_ref(q[:, 0], k, v, lens), 1e-2)


@pytest.mark.parametrize("split", [16, 32, 512])
@pytest.mark.parametrize("b,hq,hkv,S,d,dv,kvlen", [
    (2, 4, 2, 1024, 64, 64, 700),
    (1, 8, 1, 512, 128, 128, 512),
    (2, 4, 4, 512, 64, 32, 130),
    (1, 2, 2, 256, 256, 256, 1),        # single valid key
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_split_ref_matches_pallas(b, hq, hkv, S, d, dv, kvlen, split, dtype,
                                  tol):
    """The Pallas kernel reads the cache transposed to (b, hkv, S, d)."""
    arrays = dense_case(b, 1, S, hq, hkv, d, dv, seed=S + kvlen)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    want = decode_attention_bhd(jq[:, 0], jk.transpose(0, 2, 1, 3),
                                jv.transpose(0, 2, 1, 3), kvlen, blk_k=256,
                                interpret=True)
    q, k, v = _t(arrays, td)
    _close(decode_attention_split_ref(q[:, 0], k, v, kvlen, split=split),
           want, tol)


@pytest.mark.parametrize("S,b,hkv,n_sm,max_split", [
    (1024, 4, 1, 132, 128),     # gemma-2b's dense slots
    (1024, 1, 32, 132, 128),    # zamba2-7b's ring
    (68, 2, 1, 132, 128),       # the lockstep check's cache
    (1003, 2, 2, 132, 128),     # S off the split
    (5, 1, 1, 132, 128),        # shorter than one split
    (32768, 1, 1, 132, 104),    # a long cache, capped by shared memory
    (4096, 8, 4, 114, 128),     # another card
])
def test_split_plan(S, b, hkv, n_sm, max_split):
    """Every key below S lies in exactly one range; ranges are multiples
    of 8 keys (or S) and at most max_split; the blocks fill every SM where
    ranges of 8 keys would."""
    split, n_split = da.split_plan(S, b, hkv, n_sm, max_split)
    assert 1 <= split <= max_split and (split % 8 == 0 or split == S)
    starts = np.arange(n_split) * split
    covered = np.concatenate([np.arange(s0, min(s0 + split, S))
                              for s0 in starts])
    np.testing.assert_array_equal(covered, np.arange(S))
    if -(-S // 8) * b * hkv >= n_sm:
        assert n_split * b * hkv >= n_sm


def test_split_plan_at_the_paths_shapes():
    """gemma-2b's 4 slots x 1024: ~32-key ranges (24), 172 blocks; the
    hybrid ring's 32 heads x 1024: 128-key ranges, 256 blocks."""
    assert da.split_plan(1024, 4, 1, 132) == (24, 43)
    assert da.split_plan(1024, 1, 32, 132) == (128, 8)


@pytest.mark.parametrize("g,d,dv,es", [(8, 256, 256, 4), (8, 256, 256, 2),
                                       (1, 112, 112, 4), (32, 64, 64, 4)])
def test_split_fits_shared_memory(g, d, dv, es):
    split = da._max_split(g, d, dv, es)
    assert split % 8 == 0 and split <= da.MAX_SPLIT
    assert da.smem_bytes(split, g, d, dv, es) <= da.SMEM_BYTES
    if split < da.MAX_SPLIT:
        assert da.smem_bytes(split + 8, g, d, dv, es) > da.SMEM_BYTES


def test_wrappers_on_cpu_take_the_plain_versions():
    """The wrappers' CPU path is the plain version, bit for bit."""
    q, k, v = _t(dense_case(2, 9, 9, 4, 2, 32, 32, seed=1))
    assert torch.equal(fa.flash_attention(q, k, v, pairing="g_major"),
                       attention_ref(q, k, v, pairing="g_major"))
    lens = torch.tensor([1, 9], dtype=torch.int32)
    assert torch.equal(da.decode_attention(q[:, :1], k, v, lens)[:, 0],
                       decode_attention_ref(q[:, 0], k, v, lens))
    assert torch.equal(da.decode_attention(q[:, :1], k, v, 5)[:, 0],
                       decode_attention_ref(q[:, 0], k, v, 5))
