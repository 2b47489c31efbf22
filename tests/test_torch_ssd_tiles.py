"""The algorithm of the redesigned K5 (the Mamba-2 SSD chunked scan), in
plain PyTorch on the CPU.

``ssd_chunked_tiled_ref`` walks the scan as the bf16 kernels do: a chunk
pass (cum by the kernels' warp scan, w, the chunk states with w x split
into two bf16 pieces, C.B^T in 64 x 64 tiles once per group), the
inter-chunk scan (h_prev split into three bf16 pieces), and the output per
64-row query tile. It returns y in float32, before the last rounding.

Held, on inputs made from seeds with numpy:

  * to the plain version ``ssd_chunked_ref`` and to JAX ``ssd_chunked``:
    float32 within 1e-5 (another summation order). bf16 within the
    existing 2e-2 against both, and within atol 1e-3, rtol 4e-3 against
    the plain version: the plain y is the walk's y rounded to bf16 (half a
    bf16 ulp, 2^-8 relative) but where a rounding of M or w lands the other
    way after the f32 sums before it differ (largest seen here ~2e-4 beyond
    the rtol term);
  * to the sequential oracle and the Pallas kernel in interpret mode
    within 5e-3, as ``test_plain_matches_sequential_and_pallas`` does;
  * its pieces: the two-piece split of w x and the three-piece split of a
    float32 state reconstruct their values exactly, and the warp-scan order
    of cum stays within float32 rounding of a float64 prefix sum;
  * ``ops.kernel_plan`` at the paths' shapes: grids that give every SM
    more than one block, shared memory under ``MAX_SMEM_BYTES`` with room
    for two chunk-kernel and four out-kernel blocks an SM, C.B^T shared by
    all of a group's heads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as pallas_ssd
from repro.kernels.ssd.ref import ssd_ref
from repro.models import ssd as jssd
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import (TILE, scan_cum, split_pieces,
                                         ssd_chunked_ref,
                                         ssd_chunked_tiled_ref)
from test_torch_ssd import KERNEL_SHAPES, ssd_inputs

ssd_chunked = jax.jit(jssd.ssd_chunked, static_argnums=5)
BF16 = torch.bfloat16
SMS = 132                        # an H100 SXM's streaming multiprocessors


def _inputs(shape, dtype):
    b, s, h, p, g, n, chunk, init = shape
    arrs = ssd_inputs(b, s, h, p, g, n, seed=s + n + g, init=init)
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(a, jdt) if i in (0, 3, 4) else jnp.asarray(a)
          for i, a in enumerate(arrs)]
    return t, jx


# (b, s, h, p, g, n, chunk, initial state): smoke widths, a ragged single
# chunk (L = 100: a partial second tile), two B/C groups, an initial
# state, and the paths' head shapes (mamba2-370m p 64 n 128, zamba2-7b
# p 64 n 64) at a reduced s over a chunk boundary
WALK_SHAPES = [(2, 32, 4, 16, 1, 16, 8, False),
               (1, 100, 4, 16, 1, 16, 256, False),
               (2, 64, 8, 32, 2, 32, 16, False),
               (2, 48, 4, 16, 2, 16, 16, True),
               (1, 256, 2, 64, 1, 128, 128, False),
               (1, 256, 4, 64, 1, 64, 128, True),
               (1, 160, 2, 64, 1, 128, 80, True)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_tiled_ref_matches_plain_and_jax(shape, dtype):
    chunk = shape[6]
    t, jx = _inputs(shape, dtype)
    y, st = ssd_chunked_tiled_ref(*t[:5], chunk, *t[5:])
    want_y, want_st = ssd_chunked_ref(*t[:5], chunk, *t[5:])
    jy, jst = ssd_chunked(*jx[:5], chunk, *jx[5:])
    assert y.dtype == torch.float32 and st.shape == want_st.shape
    jy = np.asarray(jy, np.float32)
    if dtype == torch.float32:
        for got, want in ((y, want_y), (st, want_st), (y, jy),
                          (st, np.asarray(jst))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(y.numpy(), want_y.float().numpy(),
                                   atol=1e-3, rtol=4e-3)
        np.testing.assert_allclose(y.to(BF16).float().numpy(), jy,
                                   atol=2e-2, rtol=2e-2)
        for want in (want_st, np.asarray(jst)):
            np.testing.assert_allclose(st.numpy(), np.asarray(want),
                                       atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", KERNEL_SHAPES)
def test_tiled_ref_matches_sequential_and_pallas(b, s, h, p, g, n, chunk):
    arrs = ssd_inputs(b, s, h, p, g, n, seed=chunk)
    jx = [jnp.asarray(a) for a in arrs]
    y, st = ssd_chunked_tiled_ref(*[torch.from_numpy(a) for a in arrs],
                                  chunk)
    for want_y, want_st in (ssd_ref(*jx),
                            pallas_ssd(*jx, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(
            st.numpy(), np.asarray(want_st).reshape(st.shape), atol=5e-3,
            rtol=5e-3)


@pytest.mark.parametrize("what", ["w_x", "state"])
def test_splits_reconstruct_exactly(what):
    """w x (two bf16 values, 16 significant bits) in two bf16 pieces, a
    float32 state (24 bits, exponents over a wide range) in three."""
    rng = np.random.default_rng(7)
    if what == "w_x":
        w = torch.from_numpy(rng.uniform(1e-4, 0.2, 4096).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
        v = w.to(BF16).float() * x.to(BF16).float()
        k = 2
    else:
        v = torch.from_numpy((rng.standard_normal(4096)
                              * 10.0 ** rng.uniform(-6, 6, 4096))
                             .astype(np.float32))
        k = 3
    pieces = split_pieces(v, BF16, k)
    for piece in pieces:
        assert torch.equal(piece.to(BF16).float(), piece)
    total = pieces[0]
    for piece in pieces[1:]:
        total = total + piece
    assert torch.equal(total, v)
    assert not torch.equal(sum(split_pieces(v, BF16, k - 1)), v)


@pytest.mark.parametrize("L", [8, 100, 256])
def test_scan_cum_is_a_prefix_sum(L):
    rng = np.random.default_rng(L)
    dA = -rng.uniform(1e-3, 0.8, (3, L)).astype(np.float32)
    got = scan_cum(torch.from_numpy(dA)).numpy()
    want = np.cumsum(dA.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    assert np.array_equal(got[:, :1], dA[:, :1])


# (name, b, s, h, p, g, n): the paths' shapes, chunk 256
PATH_SHAPES = [("mamba2-370m", 4, 512, 32, 64, 1, 128),
               ("zamba2-7b", 1, 512, 112, 64, 1, 64)]


@pytest.mark.parametrize("name,b,s,h,p,g,n", PATH_SHAPES)
def test_plan_fills_the_card(name, b, s, h, p, g, n):
    plan = ops.kernel_plan(b, s, h, p, g, n, 256, BF16)
    assert plan["route"] == "tensor_cores"
    assert (plan["L"], plan["nc"], plan["tiles"]) == (256, 2, 256 // TILE)
    kern = plan["kernels"]
    for k in kern.values():
        assert k["smem"] <= ops.MAX_SMEM_BYTES
    # shared memory leaves room for two state walks and four out blocks
    # an SM
    assert kern["chunk"]["resident_by_smem"] >= 2
    assert kern["out"]["resident_by_smem"] >= 4
    # every SM gets more than one block of each kernel
    assert min(k["blocks"] for k in kern.values()) > SMS
    # the state walks: two column slices of 32 a head
    assert plan["state_cols"] == 32
    assert plan["state_blocks"] == b * h * 2
    assert plan["cb_blocks"] == b * 2 * g * 10       # 4 x 5 / 2 tiles
    assert kern["out"]["blocks"] == 4 * b * 2 * h
    assert plan["heads_per_cb_tile"] == h // g
    assert plan["splits"] == {"w_x": 2, "h_prev": 3}
    assert ops.kernel_plan(b, s, h, p, g, n, 256, torch.float32)[
        "kernels"]["f32"]["blocks"] == b * h


def test_plan_shared_memory_by_shape():
    """The mamba2-370m blocks: the chunk kernel's dt, cum, w and scan
    totals (float32) and three stages of a B tile and a 32-column x tile;
    the out kernel's C tile, four x tiles (later two stages of h_prev's
    three pieces, 32 rows of n each), cum and dt (bf16 rows padded by 16
    bytes)."""
    assert ops.smem_bytes("chunk", 128, 64, 256) == \
        4 * 256 * 4 + 3 * 64 * (136 + 40) * 2 == 71680
    assert ops.smem_bytes("out", 128, 64, 256) == \
        (64 * 136 + 256 * 72) * 2 + 2 * 256 * 4 == 56320
    # a short chunk still holds the two h_prev stages
    assert ops.smem_bytes("out", 16, 16, 8) == \
        (64 * 24 + 192 * 24) * 2 + 2 * 64 * 4
    # a chunk too long for the out block is refused before any launch
    assert ops.smem_bytes("out", 128, 128, 2048) > ops.MAX_SMEM_BYTES
