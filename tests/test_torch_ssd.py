"""The port's Mamba-2 SSD pieces against the reference on the CPU:

  * the plain version of K5 (``kernels.ssd.ref.ssd_chunked_ref``, what the
    wrapper runs on CPU tensors) against JAX ``ssd_chunked`` at f32 within
    1e-5 (the same chunked math, summed in another order), including a
    ragged single chunk, two B/C groups and an initial state, and at bf16
    within 2e-2 (both round m, w and y to bf16 at the same points; a
    rounding of m may flip where the f32 sums before it differ);
  * on the three shapes of test_kernels.py's SSD test, against the
    sequential oracle and the Pallas kernel in interpret mode, within that
    test's 5e-3;
  * the ``ValueError`` when ``min(chunk, s)`` does not divide s;
  * ``ssd_decode_step``, ``causal_conv``, ``mamba_full`` and
    ``mamba_decode`` against the reference at f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.ssd.ops import ssd as pallas_ssd
from repro.kernels.ssd.ref import ssd_ref
from repro.models import ssd as jssd
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_sequential_ref
from repro_torch.models import ssd as tssd
from repro_torch.weights import numpy_to_torch

# the reference functions, jitted: one compile each instead of one per op
ssd_chunked = jax.jit(jssd.ssd_chunked, static_argnums=5)
mamba_full = jax.jit(jssd.mamba_full, static_argnums=2)
mamba_decode = jax.jit(jssd.mamba_decode, static_argnums=3)


def ssd_inputs(b, s, h, p, g, n, seed, init=False):
    """x, dt, A, B, C (and an initial state) as numpy, scaled as
    test_kernels.py scales them."""
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
           rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32),
           -np.linspace(1.0, 8.0, h).astype(np.float32),
           (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32),
           (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)]
    if init:
        out.append((rng.standard_normal((b, g, h // g, n, p)) * 0.5)
                   .astype(np.float32))
    return out


def _jax(arrs, dtype=jnp.float32):
    x, dt, A, B, C = arrs[:5]
    return [jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, dtype), jnp.asarray(C, dtype)] + \
        [jnp.asarray(a) for a in arrs[5:]]


def _torch(arrs, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return t


def _np(t):
    return t.float().numpy()


# (b, s, h, p, g, n, chunk, with an initial state)
CHUNKED = [(2, 32, 4, 16, 1, 16, 8, False),
           (1, 100, 4, 16, 1, 16, 256, False),     # ragged: L = s = 100
           (2, 64, 8, 32, 2, 32, 16, False),       # two B/C groups
           (2, 48, 4, 16, 2, 16, 16, True)]        # an initial state


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", CHUNKED)
def test_plain_matches_ssd_chunked_f32(b, s, h, p, g, n, chunk, init):
    arrs = ssd_inputs(b, s, h, p, g, n, seed=s + g, init=init)
    jx = _jax(arrs)
    want_y, want_st = ssd_chunked(*jx[:5], chunk, *jx[5:])
    tt = _torch(arrs)
    got_y, got_st = ops.ssd(*tt[:5], chunk, *tt[5:])
    assert got_y.dtype == torch.float32 and got_st.shape == want_st.shape
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(got_st), np.asarray(want_st), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init",
                         [CHUNKED[0], CHUNKED[1], CHUNKED[3]])
def test_plain_matches_ssd_chunked_bf16(b, s, h, p, g, n, chunk, init):
    arrs = ssd_inputs(b, s, h, p, g, n, seed=s + g, init=init)
    jx = _jax(arrs, jnp.bfloat16)
    want_y, want_st = ssd_chunked(*jx[:5], chunk, *jx[5:])
    tt = _torch(arrs, torch.bfloat16)
    got_y, got_st = ops.ssd(*tt[:5], chunk, *tt[5:])
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(got_st), np.asarray(want_st), atol=2e-2,
                               rtol=2e-2)


# test_kernels.py's shapes: (b, s, h, p, g, n, chunk)
KERNEL_SHAPES = [(2, 128, 4, 16, 1, 16, 32), (1, 256, 8, 32, 2, 64, 64),
                 (1, 64, 2, 64, 1, 128, 64)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", KERNEL_SHAPES)
def test_plain_matches_sequential_and_pallas(b, s, h, p, g, n, chunk):
    arrs = ssd_inputs(b, s, h, p, g, n, seed=chunk)
    jx = _jax(arrs)
    y_seq, st_seq = ssd_ref(*jx)
    y_pl, st_pl = pallas_ssd(*jx, chunk=chunk, interpret=True)
    tt = _torch(arrs)
    got_y, got_st = ops.ssd(*tt, chunk)
    seq_y, seq_st = ssd_sequential_ref(*tt)
    for want_y, want_st in ((y_seq, st_seq), (y_pl, st_pl)):
        np.testing.assert_allclose(_np(got_y), np.asarray(want_y),
                                   atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(
            _np(got_st), np.asarray(want_st).reshape(got_st.shape),
            atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(_np(seq_y), np.asarray(y_seq), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(seq_st), np.asarray(st_seq), atol=1e-5,
                               rtol=1e-5)


def test_chunk_must_divide_the_sequence():
    tt = _torch(ssd_inputs(1, 100, 2, 16, 1, 16, seed=0))
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd(*tt, 64)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_chunked_ref(*tt, 64)
    with pytest.raises(ValueError):
        jssd.ssd_chunked(*_jax(ssd_inputs(1, 100, 2, 16, 1, 16, seed=0)), 64)


def test_decode_step_matches_reference():
    b, h, p, g, n = 2, 4, 16, 2, 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, h)).astype(np.float32)
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    B, C = (rng.standard_normal((2, b, g, n)) * 0.3).astype(np.float32)
    st = rng.standard_normal((b, g, h // g, n, p)).astype(np.float32)
    args = (x, dt, A, B, C, st)
    want_y, want_st = jssd.ssd_decode_step(*map(jnp.asarray, args))
    got_y, got_st = tssd.ssd_decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal((12,)).astype(np.float32)
    want = jssd.causal_conv(*map(jnp.asarray, (x, w, bias)))
    got = tssd.causal_conv(*map(torch.from_numpy, (x, w, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def block():
    """mamba2-370m smoke's block params, the reference's and the port's."""
    jcfg = jax_smoke("mamba2-370m").replace(remat=False,
                                            compute_dtype="float32")
    tcfg = get_smoke_config("mamba2-370m").replace(remat=False,
                                                   compute_dtype="float32")
    jp = jssd.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = {k: numpy_to_torch(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("s", [2, 16])      # s < K-1 pads the conv state
def test_mamba_full_matches_reference(block, s):
    jcfg, jp, tcfg, tp = block
    xt = np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    want, (wconv, wssm) = mamba_full(jp, jnp.asarray(xt), jcfg)
    got, (gconv, gssm) = tssd.mamba_full(tp, torch.from_numpy(xt), tcfg)
    for g, w in ((got, want), (gconv, wconv), (gssm, wssm)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_mamba_decode_matches_reference(block):
    jcfg, jp, tcfg, tp = block
    rng = np.random.default_rng(7)
    xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    m = jcfg.ssm
    conv_dim = m.expand * jcfg.d_model + 2 * m.n_groups * m.d_state
    h = m.expand * jcfg.d_model // m.head_dim
    conv = rng.standard_normal((2, m.conv_kernel - 1, conv_dim)).astype(
        np.float32)
    ssm = rng.standard_normal((2, m.n_groups, h // m.n_groups, m.d_state,
                               m.head_dim)).astype(np.float32)
    want, (wconv, wssm) = mamba_decode(
        jp, jnp.asarray(xt), (jnp.asarray(conv), jnp.asarray(ssm)), jcfg)
    got, (gconv, gssm) = tssd.mamba_decode(
        tp, torch.from_numpy(xt),
        (torch.from_numpy(conv), torch.from_numpy(ssm)), tcfg)
    for g, w in ((got, want), (gconv, wconv), (gssm, wssm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
