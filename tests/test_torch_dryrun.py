"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, and the kernel wrappers' ``meta`` route it runs on.

  * for all 40 cells, ``n_params``, ``n_active_params``, ``tokens`` and
    ``model_flops`` equal the reference's (its trees through
    ``jax.eval_shape``; nothing is compiled);
  * one cell through ``python -m repro_torch.launch.dryrun`` (whisper-tiny,
    decode_32k, the 16x16 mesh), the counterpart of
    ``tests/test_sharding.py``'s, and one in process with the reference's
    keys, each null field with its reason;
  * the sizing on a 1 x 1 mesh equals the bytes the tensors hold;
  * experiment C1's override (``kv_cache_dtype=float8_e4m3fn``) sizes the
    decode state at one byte per cache element, as the reference's;
  * each wrapper's ``meta`` output has its plain version's shapes and
    dtypes on the CPU, and adds the kernel's work to an open count; on
    ``meta`` it allocates the workspace its launch would;
  * the work formulas against the loops they replace.

The whole sweep (64 cells on ``meta``) is ``chip_smoke.py``'s, not here.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.tree_util import tree_leaves as jax_leaves

from repro.configs import get_config as ref_config
from repro.models import abstract_decode_state as ref_abstract_state
from repro.models import abstract_params as ref_abstract_params
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 get_smoke_config)
from repro_torch.distributed.sharding import param_shardings
from repro_torch.kernels import work
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.ssd import ops as ssd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import abstract_decode_state, build
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]

REF_KEYS = ("arch", "shape", "overrides", "kind", "mesh", "n_devices", "ok",
            "lower_s", "compile_s", "n_params", "n_active_params", "tokens",
            "model_flops", "hlo_flops_per_device", "hlo_bytes_per_device",
            "xla_cost_flops_unscaled", "xla_cost_bytes_unscaled",
            "collectives", "memory")
REF_MEMORY_KEYS = ("temp_size_in_bytes", "argument_size_in_bytes",
                   "output_size_in_bytes", "generated_code_size_in_bytes")


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored after
    (its import forces 512 host devices for the process)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_counts_match_reference(arch, ref_dryrun):
    jcfg, cfg = ref_config(arch), get_config(arch)
    jparams = ref_abstract_params(jcfg)
    n_params = ref_dryrun.count_params(jparams)
    n_active = ref_dryrun.active_params(jcfg, jparams)
    params = dryrun.abstract_params(cfg)
    for shape in SHAPES:
        # the reference's run_cell computes these two inline
        tokens = shape.global_batch * (shape.seq_len if shape.kind
                                       != "decode" else 1)
        model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
        got = dryrun.cell_counts(cfg, shape, params)
        assert got == {"n_params": n_params, "n_active_params": n_active,
                       "tokens": tokens, "model_flops": float(model_flops)}


def test_dryrun_cli_sizes_one_cell(tmp_path):
    """whisper-tiny decode_32k on the 16x16 mesh, on meta, in a process of
    its own."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dry-run complete: 1 ok, 0 failed, 0 skipped" in r.stdout
    cell = json.loads((tmp_path / "whisper-tiny__decode_32k__single.json")
                      .read_text())
    assert cell["ok"] and cell["n_devices"] == 256
    assert cell["hlo_flops_per_device"] > 0
    assert cell["kernel_calls"] == {"K3": 4, "K4": 4}


def test_run_cell_keeps_the_reference_keys():
    for multi in (False, True):
        cell = dryrun.run_cell("mamba2-370m", "long_500k", multi)
        assert set(REF_KEYS) <= set(cell)
        assert set(cell["memory"]) == set(REF_MEMORY_KEYS)
        assert cell["n_devices"] == (512 if multi else 256)
        nulls = [k for k in REF_KEYS if cell[k] is None] + [
            k for k in REF_MEMORY_KEYS if cell["memory"][k] is None]
        assert nulls and all(k in cell["null_reasons"] for k in nulls)
        assert set(cell["estimates"]) == {"hlo_flops_per_device",
                                          "hlo_bytes_per_device"}
        assert cell["memory"]["argument_size_in_bytes"] == sum(
            cell["argument_groups"].values())
        assert 0 < cell["hlo_flops_per_device"] < cell["flops_total"]
        assert cell["kernel_calls"] == {}     # a decode step runs no scan


def test_decode_kernel_work_splits_as_the_decode_state():
    """gemma-2b decode_32k on 16x16: the rules split the caches K4 reads
    over data by row and over model by position, so each device does
    1/256 of the kernel's work; the aten work splits as the weights."""
    cell = dryrun.run_cell("gemma-2b", "decode_32k", False)
    split = cell["per_device"]
    assert split["kernel_split_by"] == "decode state"
    assert split["kernel_fraction"] == 1 / 256
    assert cell["hlo_flops_per_device"] == pytest.approx(
        cell["aten_flops"] * split["fraction"]
        + cell["kernel_flops"]["K4"] / 256, rel=1e-12)


def test_fp8_kv_cache_override_halves_the_decode_state():
    """Experiment C1, deepseek-67b decode_32k under ``--override
    kv_cache_dtype=float8_e4m3fn``, on meta: the decode step runs (K4 on
    the fp8 cache in each of the 95 layers), and the decode state's bytes,
    per device under the rules and in all, are half the bf16 ones and the
    reference's ``abstract_decode_state`` bytes under the override."""
    over = {"kv_cache_dtype": "float8_e4m3fn"}
    fp8 = dryrun.run_cell("deepseek-67b", "decode_32k", False, over)
    bf16 = dryrun.run_cell("deepseek-67b", "decode_32k", False)
    assert fp8["ok"] and fp8["kernel_calls"] == {"K4": 95}
    assert 2 * fp8["argument_groups"]["decode_state"] == \
        bf16["argument_groups"]["decode_state"]
    shape = dryrun.SHAPES_BY_NAME["decode_32k"]
    b, s = shape.global_batch, shape.seq_len

    def held(cfg):
        return sum(t.numel() * t.element_size()
                   for t in leaves(abstract_decode_state(cfg, b, s)))

    ref = jax_leaves(ref_abstract_state(
        ref_config("deepseek-67b").replace(**over), b, s))
    cfg = get_config("deepseek-67b")
    assert 2 * held(cfg.replace(**over)) == held(cfg)
    assert held(cfg.replace(**over)) == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize for x in ref)


def test_sizing_on_one_device_is_the_bytes_held():
    cfg = get_smoke_config("gemma-2b")
    params = build(cfg).init_train_params(device="cpu")
    mesh = make_local_mesh("cpu")
    held = sum(t.numel() * t.element_size() for t in leaves(params))
    assert dryrun.tree_bytes(params, param_shardings(cfg, mesh,
                                                     params)) == held
    # the distinct slices of a mesh whose positions share the device tile
    # each leaf once
    two = make_local_mesh(devices=["cpu", "cpu"])
    pieces = dryrun.placed_pieces(cfg, params, two)
    assert len(pieces) > len(leaves(params))
    assert sum(n for _, n in pieces) == held


def _meta(*ts):
    return [t.to("meta") if torch.is_tensor(t) else t for t in ts]


def _cases():
    """(kernel, wrapper call on the given tensors, its inputs on the CPU,
    kwargs, the count's formula or None where meta cannot be counted)."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g)
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v = rnd(b, 8, hq, d), rnd(b, 8, hkv, d), rnd(b, 8, hkv, d)
    pool_k, pool_v = rnd(9, 8, hkv, d), rnd(9, 8, hkv, d)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    vals = torch.tensor([4, 1], dtype=torch.int32)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    x, dt = rnd(b, 16, 4, 16), torch.rand(b, 16, 4)
    A, B, C = -torch.rand(4), rnd(b, 16, 1, 16), rnd(b, 16, 1, 16)
    return [
        ("K1", pa.paged_prefill_attention,
         (q[:, :4], pool_k, pool_v, lens, vals, tables), {}, None),
        ("K2", pa.paged_attention, (q[:, :1], pool_k, pool_v, lens, tables),
         {}, None),
        ("K3", fa.flash_attention, (q, k, v), {"causal": True},
         work.k3_flops(b, 8, 8, hq, d, d, True)),
        ("K4", da.decode_attention, (q[:, :1], k, v, 6), {},
         work.k4_flops([6, 6], hq, d, d)),
        ("K5", ssd.ssd, (x, dt, A, B, C, 8), {},
         work.k5_flops(b, 16, 4, 16, 1, 16, 8)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_wrapper_meta_output_and_count(case):
    kernel, fn, args, kw, flops = case
    args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
    plain = fn(*args, **kw)
    launches = fn.launches
    with work.count_work() as w:
        assert not w.calls
        if flops is None:
            with pytest.raises(ValueError, match="meta"):
                fn(*_meta(*args), **kw)
        else:
            got = fn(*_meta(*args), **kw)
            assert w.flops == {kernel: flops} and w.calls == {kernel: 1}
    got = fn(*_meta(*args), **kw)             # no count open: no formula
    plain = plain if isinstance(plain, tuple) else (plain,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in got)
    assert fn.launches == launches
    if kernel == "K3":                        # the lse of the gradient path
        out, lse = fa.flash_attention_lse(*_meta(*args))
        _, want = fa.flash_attention_lse(*args)
        assert (lse.shape, lse.dtype, out.device.type) == \
            (want.shape, want.dtype, "meta")


def _workspace_cases():
    """(kernel, wrapper, its meta inputs, the bytes of the workspace a
    launch of that call allocates, by the wrapper's own plan)."""
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    b, hq, hkv, d, S = 2, 8, 1, 256, 32768
    n_sm = da.sm_count(torch.device("meta"))
    _, n4 = da.split_plan(S, b, hkv, n_sm, da._max_split(hq // hkv, d, d, 2))
    q2 = m(b, 1, hq, d, dt=torch.bfloat16)
    pool = m(65, 16, hkv, d, dt=torch.bfloat16)
    lens = m(b, dt=torch.int32)
    tables = m(b, 64, dt=torch.int32)
    _, n2 = pa.decode_plan(64, 16, b, hq, hkv, d, d, 2, n_sm)
    bs, s, h, p, g, n = 2, 256, 8, 64, 1, 128
    plan = ssd.kernel_plan(bs, s, h, p, g, n, 256, torch.bfloat16)
    nc, Lt = plan["nc"], plan["tiles"] * ssd.TILE
    return [
        ("K2", pa.paged_attention, (q2, pool, pool, lens, tables),
         b * hq * n2 * (d + 2) * 4),
        ("K3", fa.flash_attention, (m(b, 64, hq, d, dt=torch.bfloat16),
                                    m(b, 64, hkv, d, dt=torch.bfloat16),
                                    m(b, 64, hkv, d, dt=torch.bfloat16)), 0),
        ("K4", da.decode_attention,
         (q2, m(b, S, hkv, d, dt=torch.bfloat16),
          m(b, S, hkv, d, dt=torch.bfloat16), S - 1),
         b * hq * n4 * (d + 2) * 4),
        ("K5", ssd.ssd, (m(bs, s, h, p, dt=torch.bfloat16), m(bs, s, h),
                         m(h), m(bs, s, g, n, dt=torch.bfloat16),
                         m(bs, s, g, n, dt=torch.bfloat16), 256),
         bs * h * s * 4 + bs * nc * g * Lt * Lt * 4
         + 3 * bs * nc * h * n * p * 2),
    ]


@pytest.mark.parametrize("case", _workspace_cases(), ids=lambda c: c[0])
def test_wrapper_meta_allocates_the_launch_workspace(case):
    """On meta a wrapper allocates what its launch on the card would: the
    outputs and the workspace its plan sizes, so the dry-run's bytes
    materialized are the card's."""
    from repro_torch.launch.hlo_analysis import _Materialized
    kernel, fn, args, ws = case
    with _Materialized() as mat:
        out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    held = sum(t.numel() * t.element_size() for t in out)
    assert ws > 0 or kernel == "K3"
    assert mat.bytes == held + ws


def test_work_formulas_equal_their_loops():
    hq, d, dv = 3, 16, 8
    for off, val, C in [(0, 0, 4), (0, 4, 4), (37, 1, 1), (5, 2, 8),
                        (19, 8, 8)]:
        kv_len = max(off + val, 1)
        want = sum(min(off + i + 1, kv_len) for i in range(C))
        assert work.k1_flops([off], [val], C, hq, d, dv) == \
            want * hq * 2 * (d + dv)
    for sq, skv in [(1, 1), (33, 33), (64, 1500), (1500, 64)]:
        pairs = sum(min(i + 1, skv) for i in range(sq))
        assert work.k3_flops(2, sq, skv, hq, d, dv, True) == \
            2 * pairs * hq * 2 * (d + dv)
        assert work.k3_flops(2, sq, skv, hq, d, dv, False) == \
            2 * sq * skv * hq * 2 * (d + dv)
    assert work.lengths(5, 3, "n") == [5, 5, 5]
    assert work.lengths(torch.tensor([1, 2]), 2, "n") == [1, 2]
    np.testing.assert_equal(work.k2_flops([1, 2], hq, d, dv),
                            work.k4_flops([3], hq, d, dv))
