"""Chunked-prefill paged attention of the PyTorch port.

On the CPU the wrapper takes the plain version, which is held against the
reference's quadratic oracle (both pairings) and against the Pallas kernel
in interpret mode, on the ``_mixed_case`` shapes of test_megastep.py with
ragged valids, at float32 with atol = rtol = 1e-5. The CUDA kernel is held
against the plain version on the card in test_torch_kernels_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_prefill_attention_bcd
from repro.kernels.paged_attention.ref import paged_prefill_attention_ref
from repro_torch.kernels.paged_attention import ops, ref
from test_torch_kernels_gpu import CASES, case as _case

jax_ref = jax.jit(paged_prefill_attention_ref, static_argnames=("pairing",))


def _t(case):
    return [torch.from_numpy(x) for x in case]


def _j(case):
    return [jnp.asarray(x) for x in case]


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
@pytest.mark.parametrize("shape,C", CASES)
def test_plain_matches_reference_oracle(shape, C, pairing):
    case = _case(shape, C)
    want = np.asarray(jax_ref(*_j(case), pairing=pairing))
    got = ref.paged_prefill_attention_ref(*_t(case), pairing=pairing)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,C", [("gqa", 1), ("mqa", 16),
                                     ("wide", 64)])
def test_plain_matches_pallas_interpret(shape, C):
    """The Pallas kernel maps q-head h to kv head h // g (kv_major)."""
    case = _case(shape, C)
    want = np.asarray(paged_prefill_attention_bcd(*_j(case),
                                                  interpret=True))
    got = ops.paged_prefill_attention(*_t(case), pairing="kv_major")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pairing", ["kv_major", "g_major"])
def test_contig_twin_equals_paged_on_cpu(pairing):
    """The gathered-view twin reshapes the contiguous view into a pool; on
    the CPU both run the plain version and must agree bit for bit."""
    q, k, v, lens, vals, pt = _t(_case("wide", 24))
    paged = ops.paged_prefill_attention(q, k, v, lens, vals, pt,
                                        pairing=pairing)
    twin = ops.paged_prefill_attention_contig(
        q, ref.gather_pages(k, pt), ref.gather_pages(v, pt), lens, vals, pt,
        pairing=pairing)
    assert torch.equal(paged, twin)


def test_wrapper_dispatch_by_device():
    """CPU tensors take the plain version without counting a launch; meta
    tensors (the dry-run's) give an empty output of the kernel's shape and
    dtype, never the plain version, and launch nothing; an unknown pairing
    raises."""
    case = _t(_case("gqa", 8))
    before = ops.paged_prefill_attention.launches
    out = ops.paged_prefill_attention(*case)
    assert out.shape == (3, 8, 4, 32)
    assert ops.paged_prefill_attention.launches == before
    meta = ops.paged_prefill_attention(*[x.to("meta") for x in case])
    assert (meta.device.type, meta.shape, meta.dtype) == \
        ("meta", out.shape, out.dtype)
    assert ops.paged_prefill_attention.launches == before
    with pytest.raises(ValueError):
        ops.paged_prefill_attention(*case, pairing="h_major")


def test_inactive_rows_stay_finite_on_zeroed_null_block():
    """valids == 0 rows see one (null) key under the kv_len >= 1 clamp and
    give finite output, never a 0/0 NaN."""
    q, k, v, lens, vals, pt = _t(_case("gqa", 8))
    vals = torch.zeros_like(vals)
    lens = torch.zeros_like(lens)
    pt = torch.zeros_like(pt)
    out = ops.paged_prefill_attention(q, k, v, lens, vals, pt)
    assert torch.isfinite(out).all()

