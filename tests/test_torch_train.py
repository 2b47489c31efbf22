"""The port's training path against the reference's, on the CPU at f32:

  * ``loss`` and every gradient leaf of every architecture against
    ``jax.value_and_grad(model.loss, has_aux=True)`` from the same
    converted params and the same ``SyntheticLM`` batch (one JAX compile
    each);
  * remat on (under "full" and "dots") and off give equal gradients;
  * K3's gradient (``backward.flash_attention_backward``, what
    ``FlashAttentionFn`` runs) and K5's (``backward.ssd_backward``, what
    ``SSDFn`` runs) against ``jax.vjp`` of the reference's
    ``layers.attention`` and ``ssd_chunked``;
  * ``optimizer.update`` against the reference's for the same gradients,
    with and without ``compress_grads``;
  * ``make_train_step``'s losses and ``make_serve_steps``' logits against
    the reference's;
  * the captured step's route (``TrainStep``'s static batch and replays;
    on the CPU ``graphs.capture_eager`` replays by running the step
    again): three steps equal the eager ones bit for bit (params, moments,
    step, residual, metrics) and the reference's within the losses'
    tolerance, with and without compression and with a VLM's float
    batch; a restored tree drops the graph and captures anew;
  * the data stream equal to the reference's.

On the CPU the kernels' wrappers run the plain versions, which autograd
differentiates. The Functions launch the kernels, so they run on the card
alone (``test_torch_kernels_gpu.py``); their backward functions are plain
torch and are called directly here, from the plain forward's values.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as ref_smoke
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import build as ref_build
from repro.models.layers import attention as jax_attention
from repro.models.ssd import ssd_chunked as jax_ssd_chunked
from repro.training import optimizer as ref_opt
from repro.training.data import SyntheticLM as RefSyntheticLM
from repro.training.train_step import make_serve_steps as ref_serve_steps
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.backward import \
    flash_attention_backward
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.backward import ssd_backward
from repro_torch.models import build
from repro_torch.serving import graphs
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_step import (make_serve_steps,
                                             make_train_step, value_and_grad)
from repro_torch.tree import leaves, tree_map
from repro_torch.weights import params_from_jax, train_params_from_jax

LOSS_TOL = 1e-5      # f32, summation order
GRAD_TOL = 1e-4      # each leaf: max |diff| <= GRAD_TOL * max(1, max |g|)


def _cfgs(arch, **kw):
    """The reference's and the port's smoke config at f32."""
    return (ref_smoke(arch).replace(compute_dtype="float32", **kw),
            get_smoke_config(arch).replace(compute_dtype="float32", **kw))


def _ref_params(cfg, seed=0):
    return ref_build(cfg).init_params(jax.random.PRNGKey(seed))


def _to_port(params):
    return train_params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _to_jax(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _leaf_errs(want, got):
    """Per leaf of the two trees (JAX's order), max |diff| over
    max(1, max |want|)."""
    w, g = jax.tree_util.tree_leaves(want), leaves(got)
    assert len(w) == len(g)
    out = []
    for a, b in zip(w, g):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape
        out.append(np.abs(a - b).max() / max(1.0, np.abs(a).max()))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_equal_reference(arch):
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=1, device="cpu").batch_at(3)
    (val, met), grads = jax.jit(jax.value_and_grad(
        ref_build(rcfg).loss, has_aux=True))(params, _to_jax(batch))
    (pval, pmet), pgrads = value_and_grad(build(cfg).loss)(
        _to_port(params), batch)
    assert abs(float(val) - float(pval)) <= LOSS_TOL
    for k in ("ce", "moe_aux", "moe_z"):
        assert abs(float(met[k]) - float(pmet[k])) <= LOSS_TOL, k
    errs = _leaf_errs(grads, pgrads)
    assert max(errs) <= GRAD_TOL, (arch, max(errs))
    # a leaf with a zero gradient in one has a zero gradient in the other
    for a, b in zip(jax.tree_util.tree_leaves(grads), leaves(pgrads)):
        assert (np.abs(np.asarray(a)).max() > 0) == bool(b.abs().max() > 0)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma-2b", "llama4-scout-17b-a16e",
                                  "mamba2-370m", "zamba2-7b",
                                  "whisper-tiny"])
def test_remat_gives_equal_gradients(arch, policy):
    """Recomputed activations are the same activations: the gradients with
    ``remat`` on, under either ``remat_policy``, and off are equal."""
    _, cfg = _cfgs(arch, remat_policy=policy)
    params = build(cfg).init_train_params(seed=0, device="cpu")
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=2, device="cpu").batch_at(0)
    (l_on, _), g_on = value_and_grad(build(cfg.replace(remat=True)).loss)(
        params, batch)
    (l_off, _), g_off = value_and_grad(build(cfg.replace(remat=False)).loss)(
        params, batch)
    assert torch.equal(l_on, l_off)
    for a, b in zip(leaves(g_on), leaves(g_off)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------- K3's gradient

# (b, sq, skv, hq, hkv, d, dv, causal, pairing)
FLASH_GRAD_CASES = [(2, 12, 12, 8, 2, 16, 16, True, "kv_major"),
                    (2, 12, 12, 8, 2, 16, 16, True, "g_major"),
                    (1, 9, 9, 4, 1, 24, 16, True, "kv_major"),
                    (2, 5, 11, 4, 4, 16, 16, False, "g_major")]


def _attn_inputs(b, sq, skv, hq, hkv, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
             (b, sq, hq, dv))]


def _jax_attention(q, k, v, causal, pairing):
    """The reference's training attention (``layers.attention`` at a short
    sequence: ``simple_attention``); ``gqa_mode="tiled"`` is the g_major
    pairing."""
    return jax_attention(q, k, v, causal=causal,
                         gqa_mode="tiled" if pairing == "g_major"
                         else "grouped")


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_gradient_equals_jax_vjp(case):
    """The plain forward and its lse, then ``flash_attention_backward``
    (``FlashAttentionFn``'s backward) against ``jax.vjp`` of the
    reference's training attention."""
    b, sq, skv, hq, hkv, d, dv, causal, pairing = case
    q, k, v, do = _attn_inputs(b, sq, skv, hq, hkv, d, dv, seed=sq + d)
    out, vjp = jax.vjp(lambda q, k, v: _jax_attention(q, k, v, causal,
                                                      pairing), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), pairing=pairing)
    got_out, lse = fa.flash_attention_lse(tq, tk, tv, **kw)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    before = flash_attention_backward.calls
    got = flash_attention_backward(tq, tk, tv, got_out, lse,
                                   torch.from_numpy(do), **kw)
    assert flash_attention_backward.calls == before + 1
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_flash_lse_equals_logsumexp():
    """The log-sum-exp K3 keeps: each row's logsumexp of its scaled
    scores, the reference's softmax normaliser, in (b, hq, sq)."""
    b, sq, hq, hkv, d = 2, 10, 6, 2, 16
    q, k, v, _ = _attn_inputs(b, sq, sq, hq, hkv, d, d, seed=5)
    for pairing in ("kv_major", "g_major"):
        lse = fa_ref.attention_lse_ref(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=True,
                                       pairing=pairing)
        assert lse.shape == (b, hq, sq)
        g = hq // hkv
        for h in range(hq):
            kvh = h % hkv if pairing == "g_major" else h // g
            s = np.einsum("bqd,bkd->bqk", q[:, :, h], k[:, :, kvh]) \
                / math.sqrt(d)
            s = np.where(np.tril(np.ones((sq, sq), bool)), s, -np.inf)
            want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
                + s.max(-1)
            np.testing.assert_allclose(lse[:, h].numpy(), want, atol=1e-5,
                                       rtol=1e-5)


def test_flash_wrapper_keeps_the_plain_path_on_cpu():
    """On the CPU, ``flash_attention`` is the plain version, which autograd
    differentiates (no Function); its gradients equal
    ``flash_attention_backward``'s, and the Function refuses CPU
    tensors rather than run the plain version."""
    q, k, v, do = _attn_inputs(2, 7, 7, 4, 2, 16, 16, seed=9)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"
    plain = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    ins = [t.detach() for t in (tq, tk, tv)]
    kw = dict(causal=True, scale=0.25, pairing="kv_major")
    lse = fa_ref.attention_lse_ref(*ins, **kw)
    got = flash_attention_backward(*ins, out.detach(), lse,
                                   torch.from_numpy(do), **kw)
    for g, w in zip(got, plain):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax_attn_ref(q, k, v, causal=True)), atol=1e-5)
    with pytest.raises(ValueError, match="device cpu"):
        fa.FlashAttentionFn.apply(tq, tk, tv, True, 0.25, "kv_major")


# --------------------------------------------------------- K5's gradient

# (b, s, h, p, g, n, chunk, initial state)
SSD_GRAD_CASES = [(2, 16, 4, 8, 1, 8, 8, False), (2, 16, 4, 8, 2, 8, 8, True),
                  (1, 12, 2, 16, 1, 16, 4, True), (2, 8, 4, 8, 1, 8, 16,
                                                   False)]


@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_ssd_gradient_equals_jax_vjp(case):
    b, s, h, p, g, n, chunk, init = case
    rng = np.random.default_rng(s * 10 + h)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5
    dt = rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32)
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.5
    st = (rng.standard_normal((b, g, h // g, n, p)).astype(np.float32) * 0.5
          if init else None)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, g, h // g, n, p)).astype(np.float32)
    ins = [x, dt, A, B, C] + ([st] if init else [])

    def jfn(x, dt, A, B, C, *st):
        return jax_ssd_chunked(x, dt, A, B, C, chunk, st[0] if st else None)

    @jax.jit
    def value_and_vjp(ins, dy, dst):
        out, vjp = jax.vjp(jfn, *ins)
        return out, vjp((dy, dst)), vjp((dy, jnp.zeros_like(out[1])))

    (y, fst), want, want_y = value_and_vjp(ins, dy, dst)
    t = [torch.from_numpy(a) for a in ins]
    st_t = t[5] if init else None
    ty, tst = ssd_ops.ssd(*t[:5], chunk, st_t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(fst),
                               atol=1e-5, rtol=1e-5)
    before = ssd_backward.calls
    got = ssd_backward(*t[:5], chunk, st_t, torch.from_numpy(dy),
                       torch.from_numpy(dst))
    assert ssd_backward.calls == before + 1
    for name, gg, w in zip("x dt A B C state".split(), got, want):
        w = np.asarray(w)
        assert np.abs(gg.numpy() - w).max() <= 1e-4 * max(1.0,
                                                          np.abs(w).max()), \
            name
    # no gradient for the final state: the backward takes None
    dx = ssd_backward(*t[:5], chunk, st_t, torch.from_numpy(dy), None)
    np.testing.assert_allclose(dx[0].numpy(), np.asarray(want_y[0]),
                               atol=1e-4, rtol=1e-4)
    assert (dx[5] is None) == (not init)
    # SSDFn launches the kernel: it refuses CPU tensors
    with pytest.raises(ValueError, match="device cpu"):
        ssd_ops.SSDFn.apply(*[a.requires_grad_() for a in t[:5]], chunk,
                            st_t)


# -------------------------------------------------------------- AdamW

@pytest.mark.parametrize("compress", [False, True])
def test_optimizer_update_equals_reference(compress):
    rcfg, _ = _cfgs("gemma-2b")
    params = _ref_params(rcfg)
    rng = np.random.default_rng(4)
    grad_sets = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape).astype(np.float32) * 0.05), params) for _ in range(3)]
    ocfg = dict(lr=1e-3, compress_grads=compress)
    r_state = ref_opt.init(params, ref_opt.AdamWConfig(**ocfg))
    p_params = _to_port(params)
    p_state = opt.init(p_params, opt.AdamWConfig(**ocfg))
    r_params = params
    ref_update = jax.jit(lambda g, st, p: ref_opt.update(
        g, st, p, ref_opt.AdamWConfig(**ocfg)))
    for grads in grad_sets:
        r_params, r_state, r_m = ref_update(grads, r_state, r_params)
        p_params, p_state, p_m = opt.update(
            _to_port(grads), p_state, p_params, opt.AdamWConfig(**ocfg))
        assert abs(float(r_m["grad_norm"]) - float(p_m["grad_norm"])) <= \
            1e-6 * float(r_m["grad_norm"])
    assert int(p_state.step) == int(r_state.step) == 3
    trees = [(r_params, p_params), (r_state.m, p_state.m),
             (r_state.v, p_state.v)]
    if compress:
        trees.append((r_state.err, p_state.err))
    else:
        assert p_state.err is None
    for want, got in trees:
        for a, b in zip(jax.tree_util.tree_leaves(want), leaves(got)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max())


def test_train_step_losses_equal_reference():
    """Three steps of ``make_train_step`` from the same params on the same
    stream: the losses within 1e-4 of the reference's."""
    rcfg, cfg = _cfgs("gemma-2b", remat=False)
    ocfg = dict(lr=1e-3)
    params = _ref_params(rcfg)
    r_step = jax.jit(ref_make_train_step(rcfg, ref_opt.AdamWConfig(**ocfg)))
    r_state = ref_opt.init(params, ref_opt.AdamWConfig(**ocfg))
    p_step = make_train_step(cfg, opt.AdamWConfig(**ocfg))
    p_params = _to_port(params)
    p_state = opt.init(p_params, opt.AdamWConfig(**ocfg))
    ref_data = RefSyntheticLM(rcfg, batch=2, seq=16, seed=0)
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    for i in range(3):
        params, r_state, rm = r_step(params, r_state, ref_data.batch_at(i))
        p_params, p_state, pm = p_step(p_params, p_state, data.batch_at(i))
        assert abs(float(rm["loss"]) - float(pm["loss"])) <= 1e-4, i
        assert set(pm) == set(rm)


# ------------------------------------------------- the captured train step

def _staged(step):
    """``step`` on the graph route, the CPU's stand-in capture."""
    step.graphs = graphs.StepGraphs("cpu", capture=graphs.capture_eager)
    return step


def _assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,compress", [
    ("gemma-2b", False), ("gemma-2b", True),
    ("llava-next-mistral-7b", False)])
def test_captured_train_step_equals_eager_and_reference(arch, compress):
    """Three steps on the staged route (the first the warm-up, two
    replays) against three eager steps from the same params, bit for bit,
    and the reference's jitted step. With the step counter out of place
    a replay would keep reading the captured count: bias correction
    frozen at step 1, the params and moments off the eager ones."""
    rcfg, cfg = _cfgs(arch, remat=False)
    ocfg = dict(lr=1e-3, compress_grads=compress)
    params = _ref_params(rcfg)
    r_step = jax.jit(ref_make_train_step(rcfg, ref_opt.AdamWConfig(**ocfg)))
    r_state = ref_opt.init(params, ref_opt.AdamWConfig(**ocfg))
    eager = make_train_step(cfg, opt.AdamWConfig(**ocfg))
    staged = _staged(make_train_step(cfg, opt.AdamWConfig(**ocfg)))
    pe, pg = _to_port(params), _to_port(params)
    se, sg = (opt.init(p, opt.AdamWConfig(**ocfg)) for p in (pe, pg))
    ref_data = RefSyntheticLM(rcfg, batch=2, seq=16, seed=0)
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    for i in range(3):
        batch = data.batch_at(i)
        params, r_state, rm = r_step(params, r_state, ref_data.batch_at(i))
        pe, se, me = eager(pe, se, batch)
        out_p, out_s, mg = staged(pg, sg, batch)
        assert out_p is pg and out_s is sg
        assert set(mg) == set(me) == set(rm)
        for k in me:
            assert torch.equal(mg[k], me[k]), (i, k)
        assert abs(float(rm["loss"]) - float(mg["loss"])) <= 1e-4, i
        assert abs(float(rm["grad_norm"]) - float(mg["grad_norm"])) <= \
            1e-4 * float(rm["grad_norm"]), i
    assert int(sg.step) == int(r_state.step) == 3
    assert (sg.err is None) == (not compress)
    _assert_trees_equal((pg, sg), (pe, se))
    st = staged.graph_stats()
    assert st["cuda_graphs"] and st["graphs"] == st["first_calls"] == 1
    assert st["replays"] == 2
    if arch.startswith("llava"):
        static = next(iter(staged.graphs.steps.values())).inputs.views
        assert static["patch_embeds"].dtype == torch.float32
        assert static["tokens"].dtype == torch.int32


def test_captured_train_step_recaptures_on_a_restored_tree(tmp_path):
    """Two staged steps, a checkpoint, then the restored tree (new
    tensors, as ``--resume`` passes): the graph over the old tree is
    dropped, the next call captures anew, and the steps on the restored
    tree equal the eager steps that ran on."""
    _, cfg = _cfgs("gemma-2b", remat=False)
    ocfg = opt.AdamWConfig(lr=1e-3)
    p = build(cfg).init_train_params(seed=0, device="cpu")
    s = opt.init(p, ocfg)
    pe, se = tree_map(lambda t: t.clone(), (p, s))
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    staged = _staged(make_train_step(cfg, ocfg))
    eager = make_train_step(cfg, ocfg)
    for i in range(2):
        staged(p, s, data.batch_at(i))
        eager(pe, se, data.batch_at(i))
    ck = Checkpointer(str(tmp_path))
    ck.save(2, (p, s))
    (p2, s2), start, _ = ck.restore((p, s))
    assert start == 2 and leaves(p2)[0] is not leaves(p)[0]
    old = tree_map(lambda t: t.clone(), (p, s))
    for i in range(2, 4):
        _, _, mg = staged(p2, s2, data.batch_at(i))
        _, _, me = eager(pe, se, data.batch_at(i))
        for k in me:
            assert torch.equal(mg[k], me[k]), (i, k)
    _assert_trees_equal((p2, s2), (pe, se))
    _assert_trees_equal((p, s), old)          # the old tree is left alone
    st = staged.graph_stats()
    assert st["graphs"] == 1 and st["first_calls"] == 2
    assert st["replays"] == 2


def test_cuda_graphs_resolve_for_the_train_step():
    """The train step's route: eager off the card (``None``), refused
    there when asked for (``True``)."""
    _, cfg = _cfgs("gemma-2b", remat=False)
    p = build(cfg).init_train_params(seed=0, device="cpu")
    s = opt.init(p, opt.AdamWConfig())
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=0,
                        device="cpu").batch_at(0)
    step = make_train_step(cfg)
    step(p, s, batch)
    assert step.graph_stats() == {"cuda_graphs": False}
    with pytest.raises(ValueError, match="cuda_graphs=True needs"):
        make_train_step(cfg, cuda_graphs=True)(p, s, batch)


def test_serve_steps_equal_reference():
    """``make_serve_steps``: the prefill step's last logits and one decode
    step's, on the converted weights."""
    rcfg, cfg = _cfgs("gemma-2b", remat=False)
    params = _ref_params(rcfg)
    r_prefill, r_decode = ref_serve_steps(rcfg)
    prefill, decode = make_serve_steps(cfg)
    port = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    batch = SyntheticLM(cfg, batch=2, seq=8, seed=4, device="cpu").batch_at(0)
    np.testing.assert_allclose(
        prefill(port, batch).numpy(),
        np.asarray(r_prefill(params, _to_jax(batch))), atol=1e-4, rtol=1e-4)
    tok = batch["tokens"][:, :1]
    want, _ = r_decode(params, ref_build(rcfg).init_decode_state(2, 8),
                       jnp.asarray(tok.numpy()), 0)
    state = build(cfg).init_decode_state(2, 8, device="cpu")
    np.testing.assert_allclose(decode(port, state, tok, 0).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["gemma-2b", "llava-next-mistral-7b",
                                  "whisper-tiny"])
def test_data_stream_equals_reference(arch):
    rcfg, cfg = _cfgs(arch)
    ref_data = RefSyntheticLM(rcfg, batch=2, seq=24, seed=3)
    data = SyntheticLM(cfg, batch=2, seq=24, seed=3, device="cpu")
    for step in (0, 5):
        want, got = ref_data.batch_at(step), data.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
