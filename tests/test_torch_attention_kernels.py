"""The plain versions of kernels K2 (paged decode), K3 (flash attention) and
K4 (decode over a contiguous cache) against the reference on the CPU.

Under the "kv_major" pairing they are held to the Pallas kernels, run in
interpret mode at the reference tests' shapes and tolerances (2e-3 at f32,
2e-2 at bf16: the kernels' own tests in tests/test_kernels.py and
tests/test_paging.py). Under "g_major" they are held to what the
reference's model path runs: ``simple_attention(pairing="g_major")`` and
``attention(gqa_mode="tiled")``, at 1e-5 in f32. K3 is also checked at
ragged sq, which the Pallas wrapper does not take, against
``attention_ref``. Inputs are numpy arrays from seeds, handed to both
sides; the card-side tests of the kernels themselves are in
tests/test_torch_kernels_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_bhd
from repro.kernels.flash_attention.ops import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention.kernel import paged_attention_bhd
from repro.kernels.paged_attention.ref import gather_pages
from repro.models import layers as jax_layers
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import layers
from test_torch_kernels_gpu import decode_case, dense_case, mixed_case

DTYPES = [("float32", 2e-3), ("bfloat16", 2e-2)]


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch tensors of ``dtype`` (both
    round to bf16 to nearest even)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------- K3: flash attention

@pytest.mark.parametrize("b,sq,hq,hkv,d,dv,causal", [
    (2, 256, 4, 2, 64, 64, True),
    (1, 512, 4, 4, 128, 128, True),
    (2, 256, 4, 1, 64, 32, False),      # MQA + narrow V (MLA-like)
    (1, 384, 6, 6, 64, 64, True),       # non-pow2 seq (block 128)
    (1, 256, 8, 2, 256, 256, True),     # gemma-wide head_dim
])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_plain_matches_pallas(b, sq, hq, hkv, d, dv, causal, dtype,
                                    tol):
    (jq, jk, jv), (q, k, v) = _both(dense_case(b, sq, sq, hq, hkv, d, dv,
                                               seed=sq + d), dtype)
    want = flash_attention(jq, jk, jv, causal=causal, blk_q=128, blk_k=128,
                           interpret=True)
    _close(attention_ref(q, k, v, causal=causal), want, tol)


@pytest.mark.parametrize("b,sq,hq,hkv,d,dv,causal", [
    (2, 33, 4, 2, 32, 32, True), (1, 7, 8, 1, 64, 64, True),
    (2, 20, 6, 2, 32, 16, False)])
def test_flash_plain_at_ragged_sq(b, sq, hq, hkv, d, dv, causal):
    """Any sq: the wrapper on the CPU (the plain version) against the
    reference's attention_ref."""
    (jq, jk, jv), (q, k, v) = _both(dense_case(b, sq, sq, hq, hkv, d, dv,
                                               seed=sq), "float32")
    want = jax_attention_ref(jq, jk, jv, causal=causal)
    _close(fa.flash_attention(q, k, v, causal=causal), want, 1e-5)


@pytest.mark.parametrize("sq,hq,hkv", [(16, 4, 2), (9, 8, 1), (12, 6, 3)])
def test_flash_g_major_matches_tiled_attention(sq, hq, hkv):
    """g_major is the reference's gqa_mode="tiled" path (KV tiled, then
    attention); the port's dispatch on the CPU gives the same."""
    (jq, jk, jv), (q, k, v) = _both(dense_case(2, sq, sq, hq, hkv, 32, 32,
                                               seed=hq), "float32")
    want = jax_layers.attention(jq, jk, jv, causal=True, gqa_mode="tiled")
    _close(attention_ref(q, k, v, pairing="g_major"), want, 1e-5)
    _close(layers.attention(q, k, v, causal=True, gqa_mode="tiled"), want,
           1e-5)
    _close(layers.simple_attention(q, k, v, causal=True, pairing="g_major"),
           want, 1e-5)


# ------------------------------------------------ K4: contiguous-cache decode

@pytest.mark.parametrize("b,hq,hkv,S,d,dv,kvlen", [
    (2, 4, 2, 1024, 64, 64, 700),
    (1, 8, 1, 512, 128, 128, 512),
    (2, 4, 4, 512, 64, 32, 130),
    (1, 2, 2, 256, 256, 256, 1),        # single valid key
])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_decode_plain_matches_pallas(b, hq, hkv, S, d, dv, kvlen, dtype, tol):
    """The port's plain version reads the (b, S, hkv, d) model layout; the
    Pallas kernel is handed the same cache transposed to (b, hkv, S, d)."""
    (jq, jk, jv), (q, k, v) = _both(dense_case(b, 1, S, hq, hkv, d, dv,
                                               seed=S + kvlen), dtype)
    want = decode_attention_bhd(jq[:, 0], jk.transpose(0, 2, 1, 3),
                                jv.transpose(0, 2, 1, 3), kvlen, blk_k=256,
                                interpret=True)
    _close(decode_attention_ref(q[:, 0], k, v, kvlen), want, tol)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1), (6, 3)])
def test_decode_g_major_matches_simple_attention(hq, hkv):
    """Per-slot lengths (the dense engine) and one scalar (the lockstep
    decode) against the reference's g_major simple_attention."""
    S, b = 40, 3
    (jq, jk, jv), (q, k, v) = _both(dense_case(b, 1, S, hq, hkv, 32, 32,
                                               seed=hq), "float32")
    lens = np.array([1, 17, S], np.int32)
    want = jax_layers.simple_attention(jq, jk, jv, causal=False,
                                       kv_len=jnp.asarray(lens),
                                       pairing="g_major")
    _close(da.decode_attention(q, k, v, torch.from_numpy(lens),
                               pairing="g_major"), want, 1e-5)
    want = jax_layers.simple_attention(jq, jk, jv, causal=False, kv_len=23,
                                       pairing="g_major")
    _close(da.decode_attention(q, k, v, 23, pairing="g_major"), want, 1e-5)


# --------------------------------------------------------- K2: paged decode

@pytest.mark.parametrize("b,hq,hkv,d,dv,blk,npages,lens", [
    (3, 4, 2, 32, 32, 16, 4, (37, 1, 64)),      # ragged, non-multiple of blk
    (2, 8, 1, 64, 64, 32, 3, (95, 17)),         # MQA, partial last page
    (1, 4, 4, 64, 32, 16, 2, (32,)),            # narrow V, exact multiple
])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_paged_decode_plain_matches_pallas(b, hq, hkv, d, dv, blk, npages,
                                           lens, dtype, tol):
    q, k_pool, v_pool, _, _, pt = mixed_case(b, 1, hq, hkv, d, dv, blk,
                                             npages, seed=blk + d)
    (jq, jk, jv), (tq, tk, tv) = _both([q[:, 0], k_pool, v_pool], dtype)
    lens = np.asarray(lens, np.int32)
    want = paged_attention_bhd(jq, jk, jv, jnp.asarray(lens),
                               jnp.asarray(pt), interpret=True)
    _close(paged_attention_ref(tq, tk, tv, torch.from_numpy(lens),
                               torch.from_numpy(pt)), want, tol)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1), (6, 3)])
def test_paged_decode_g_major_matches_simple_attention(hq, hkv):
    """The reference's legacy decode on its executed path: simple_attention
    over the gathered pages, g_major, keys < lens."""
    q, k_pool, v_pool, lens, pt = decode_case(3, hq, hkv, 32, 32, 8, 5,
                                              seed=hq)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k_pool, v_pool], "float32")
    jpt = jnp.asarray(pt)
    want = jax_layers.simple_attention(
        jq[:, None], gather_pages(jk, jpt), gather_pages(jv, jpt),
        causal=False, kv_len=jnp.asarray(lens), pairing="g_major")
    got = pa.paged_attention(tq[:, None], tk, tv, torch.from_numpy(lens),
                             torch.from_numpy(pt), pairing="g_major")
    _close(got, want, 1e-5)
