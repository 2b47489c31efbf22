#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (several for the kernel cases):

1. device   — the card's name and power limit (nvidia-smi); fails without
              CUDA.
2. build    — nvcc builds the port's four kernel sources into
              build/kernels/, one process each, all started together, and
              prints each kernel's registers and spills from ptxas.
3. kernels  — each kernel against its plain PyTorch version on the card, in
              bf16 and f32, at the shapes its path gives it (gemma-2b heads:
              hq=8, hkv=1, d=dv=256; the hybrid's: hq=hkv=32, d=112):
              K1 paged chunked prefill: b=8, blk=16, C in {1, 8, 64, 256},
                 ragged valids, plus one hkv=2 case and the paths' prefill
                 shapes (b=8, C=32: the megastep's bucket; b=1, C=32: the
                 legacy chunk); bit for bit against its gathered-view twin
                 and on a second call; each row gives the kernel's route
                 (split decode at C=1, tensor cores at bf16 C>1, the walk
                 at f32 C>1) and its key ranges, and is held to the walk
                 it runs at a tighter tolerance; at C=1, K2 at
                 lens = cache_lens + 1 equals it bit for bit on the rows
                 with valids = 1;
              K2 paged decode: b=8, blk=16, histories up to ~900 tokens,
                 plus one hkv=2 case; the split plan, the split walk at a
                 tighter tolerance, equal bits on a second call;
              K3 flash attention: b=1, sq in {33, 96, 256}, plus one hkv=2
                 case, one dv != d case and the hybrid's heads at sq=512;
                 each row gives the grid, and each case is also held to
                 the tiled walk it runs (P rounded to bf16) at a tighter
                 tolerance;
              K4 decode over a contiguous cache: b=4 slots, S=1024, per-row
                 lengths from 1 up, plus one scalar-length case and the
                 hybrid's ring (b=1, S=1024) at its heads; each row gives
                 the split plan, is held to the split-K walk it runs at a
                 tighter tolerance, and checks two calls give the same
                 bits;
              K5 SSD chunked scan (bf16 within 2e-2, f32 within 1e-4):
                 mamba2-370m heads at b=4, s=512 (two chunks), zamba2-7b
                 heads at b=1, s=512, a ragged single chunk (s=100), two
                 B/C groups, an initial state; each row gives the plan
                 (bf16: two tensor-core kernels, their grids, C.B^T
                 once per group, the operand splits), is held to the walk
                 the kernels run at a tighter tolerance and to a second
                 call bit for bit.
              Times the kernel, the plain version and one PyTorch library
              call (SDPA; none computes K5), beside the least time the card
              could take.
4. main     — full-width gemma-2b (depth 18, random weights from --seed) in
              bf16 served through AgentRM -> PagedEngineBackend ->
              PagedInferenceEngine -> mixed_step_paged (K1): several agents,
              two turns each, prompts of a few hundred tokens. Checks every
              turn completes, no id is -1, one mixed_step_paged call per
              step, K1 launches == n_layers x steps, a deterministic replay,
              and profiles a prefill and a decode window.
5. legacy   — the same agents and prompts through AgentRM ->
              SerializedPagedBackend -> PagedInferenceEngine(megastep=False)
              (K1 per prefill chunk, K2 per decode step). Checks every turn
              completes, the launch counts, a deterministic replay, and
              prints the replay's token agreement with the megastep run.
6. dense    — AgentRM -> EngineBackend -> InferenceEngine (4 slots,
              max_len 1024): K3 per prefill, K4 per decode step. Checks every
              turn completes, the launch counts and a deterministic replay,
              and profiles a decode step with all 4 slots busy.
7. lockstep — full-width gemma-2b in float32, b=2, s=64: ``forward`` logits
              (K3) against ``decode_step`` fed token by token at a scalar
              cache_len (K4), within 2e-3, and ``prefill`` + ``decode_step``
              against ``forward`` on the next token.
8. ssm      — full-width, full-depth mamba2-370m (48 layers) in bf16:
              ``prefill`` of 4 prompts of 512 tokens (K5 in every layer),
              32 greedy ``decode_step``s, a replay with the same tokens,
              a profiled prefill and decode step; then f32, b=2: ``forward`` over 512 tokens against
              ``decode_step`` token by token at every position, and
              ``prefill`` of 255 + one ``decode_step`` against ``forward``
              over 256, within 2e-3, the next token equal.
9. hybrid   — full-width zamba2-7b in bf16 at full depth (81 layers):
              ``forward`` over b=1, s=512 (K3 per group, K5 per Mamba-2
              layer), 32 ``decode_step``s from position 0 (K4 per group),
              a profiled forward and decode step; then f32 at a depth cut
              to 13 layers: ``forward`` over 64
              tokens against ``decode_step`` token by token, within 2e-3.

Every kernel's launch count is set to 0 just before a path is driven and
read just after; launches made to compare a kernel with its plain version
are not counted. Then the ``{"kernels": [...]}`` line, the card's
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero before that line is printed.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core bf16
              "float32": 67e12}         # float32 outside the tensor cores
TOL = {"bfloat16": 1e-2, "float32": 1e-5}   # atol and rtol, see _check
LOCKSTEP_TOL = 2e-3                     # test_decode_matches_full_forward's
# (atol, rtol) of K1-K4 against the plain walks they run (the tiled walks
# with P rounded to bf16 on the tensor cores; the split-K decodes from the
# kernel's plan), in float32 out: a bf16 output is at most half a bf16 ulp
# (2^-8 relative) from it, K1's and K3's also moved by a rare other
# rounding of P
WALK_TOL = {("K1", "bfloat16"): (2e-3, 4e-3), ("K1", "float32"): (1e-5, 1e-5),
            ("K2", "bfloat16"): (1e-4, 4e-3), ("K2", "float32"): (1e-5, 1e-5),
            ("K3", "bfloat16"): (2e-3, 4e-3), ("K3", "float32"): (1e-5, 1e-5),
            ("K4", "bfloat16"): (1e-4, 4e-3), ("K4", "float32"): (1e-5, 1e-5),
            # K5 against ssd_chunked_tiled_ref (y before its last rounding,
            # and the final state): a bf16 y is half a bf16 ulp from it,
            # moved also by a rounding of M or w that lands the other way
            # after another summation order, and beyond the bound by one
            # bf16 ulp of y_diag (_walk_check's slack), whose rounding may
            # land the other way too; f32 differs by summation order
            ("K5", "bfloat16"): (2e-3, 4e-3), ("K5", "float32"): (1e-5, 1e-5)}
# device kernels of K1-K5 by name, for the profiler's shares. K2 runs K1's
# C = 1 kernels, so a profile cannot tell K2 from K1 at C = 1:
# _profile_calls refuses a window that launches them
KERNEL_NAMES = {"K1": ("paged_walk_kernel", "paged_tc_kernel",
                       "paged_split_kernel", "paged_merge_kernel"),
                "K2": ("paged_split_kernel", "paged_merge_kernel"),
                "K3": ("flash_kernel", "flash_tc_kernel"),
                "K4": ("decode_split_kernel", "decode_merge_kernel"),
                "K5": ("ssd_f32_kernel", "ssd_chunk_kernel", "ssd_out_kernel")}
# the workload of the serving paths: agents, new tokens per turn (base +
# a per-agent jitter), and the prompt cap in tokens
N_AGENTS, NEW_TOKENS, JITTER, PROMPT_CAP = 6, 16, 8, 384


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, flush):
    """(median device ms, mean host ms) of one call. L2 is flushed before
    each call (the serving paths find each layer's K/V cold). A sleep
    kernel keeps the device busy while the host queues the calls, so the
    events time the device, not the Python launch path, which is timed
    apart."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(1e8))
    host = 0.0
    for a, b in ev:
        flush.zero_()
        a.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        b.record()
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[len(ts) // 2], host / reps * 1e3


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def _bound(nbytes: int, flops: int, dname: str) -> dict:
    """Least time for a call's work on an H100 at its rated limit: the
    bytes it must move over HBM bandwidth against its operations over the
    peak for the input type, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _check(name, got, want, tol):
    """Kernel vs plain version (a tensor or a tuple of them), within
    ``tol`` (atol and rtol). Attention: bf16 outputs may differ by one bf16
    ulp below ~1.5 (1e-2), f32 by another summation order (1e-5)."""
    import torch
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, (g.float() - w.float()).abs().max().item())
        ok = torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
        if not ok or not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}: max_abs_err {err} beyond {tol}")
    return err


def measure(torch, flush, kernel: str, case: dict, dname: str, fn, plain,
            library, library_as_out, bound: dict, reps: int = 20,
            tol=None) -> dict:
    """Check ``fn`` (the kernel) against ``plain`` on the card, then time
    it, the plain version and ``library`` (one PyTorch call computing the
    same function, never called by the port; ``library_as_out`` maps its
    result to the kernel's layout for its error; None where no PyTorch call
    computes the function). Emits and returns the case's row."""
    tol = TOL[dname] if tol is None else tol
    out, want = fn(), plain()
    torch.cuda.synchronize()
    err = _check(f"{kernel} {case}", out, want, tol)
    ms, host_ms = time_ms(fn, reps, flush)
    plain_ms, _ = time_ms(plain, reps, flush)
    lib_ms = lib_err = None
    if library is not None:
        lib_err = (library_as_out(library()).float()
                   - want.float()).abs().max().item()
        lib_ms, _ = time_ms(library, reps, flush)
    row = {"kernel": kernel, **case, "dtype": dname, "max_abs_err": err,
           "tol": tol, "ms": ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_max_abs_err": lib_err, **bound}
    emit({"phase": "kernel_case", **row})
    return row


def _walk_check(torch, kernel: str, row: dict, got, want,
                slack=None) -> dict:
    """The kernel's output against the plain version of the walk it runs,
    within WALK_TOL (|got - want| <= atol + rtol |want|, plus ``slack``
    per element where given); adds the error and tolerance to the case's
    row."""
    atol, rtol = WALK_TOL[(kernel, row["dtype"])]
    diff = (got.float() - want).abs()
    err = diff.max().item()
    bound = atol + rtol * want.abs() + (0 if slack is None else slack)
    if not (diff <= bound).all():
        raise AssertionError(f"{kernel} {row}: {err} from its walk, beyond "
                             f"atol {atol} rtol {rtol}")
    row.update(walk_max_abs_err=err, walk_tol=[atol, rtol])
    emit({"phase": "kernel_walk", "kernel": kernel,
          **{k: row[k] for k in row if k in ("b", "C", "sq", "hq", "S",
                                             "lens", "max_len", "shape",
                                             "dtype")},
          "walk_max_abs_err": err, "walk_tol": [atol, rtol]})
    return row


def _tile_heads(x, g):
    """(b, s, hkv, d) -> (b, hkv*g, s, d) with kv head h % hkv at head h:
    K/V laid out for SDPA under the g_major pairing."""
    return x.transpose(1, 2).repeat(1, g, 1, 1)


# ------------------------------------------------------------- kernels

def _paged_case(torch, dtype, C, hkv, seed, *, b=8, hq=8, d=256, blk=16,
                npages=64, rows=None):
    """Random q and pools over shuffled pages; ``rows`` = (cache_lens,
    valids) as lists, or ragged rows (b >= 4) when None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = b * npages + 1
    q = torch.randn((b, C, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((nb, blk, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((nb, blk, hkv, d), generator=g, device="cuda").to(dtype)
    ids = torch.randperm(nb - 1, generator=g, device="cuda")[: b * npages]
    pt = (ids + 1).reshape(b, npages).to(torch.int32)
    if rows is None:
        # ragged rows: inactive, decode-like, partial, full, then random
        valids = [0, 1, max(C // 3, 1), C] + [
            int(x) for x in torch.randint(0, C + 1, (b - 4,), generator=g,
                                          device="cuda")]
        cache = [0, 37, blk + 3, 5 * blk] + [
            int(x) for x in torch.randint(0, (npages - 8) * blk, (b - 4,),
                                          generator=g, device="cuda")]
        cache = [min(c, npages * blk - C) for c in cache]
    else:
        cache, valids = rows
    lens = torch.tensor(cache, dtype=torch.int32, device="cuda")
    vals = torch.tensor(valids, dtype=torch.int32, device="cuda")
    return q, k, v, lens, vals, pt


def _prefill_bound(q, k, v, lens, vals, pt, dname) -> dict:
    """K1: q read, the K/V pages holding a key some query sees, out
    written, the row scalars and tables; 2*(d+dv) operations per visible
    key and query head."""
    b, C, hq, d = q.shape
    blk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    es = q.element_size()
    nbytes = (q.numel() + b * C * hq * dv) * es
    nbytes += (lens.numel() + vals.numel() + pt.numel()) * 4
    flops = 0
    for r in range(b):
        off, kv_len = int(lens[r]), max(int(lens[r]) + int(vals[r]), 1)
        hi = min(kv_len, off + C)            # last position any query sees
        pages = min(pt.shape[1], -(-hi // blk))
        nbytes += pages * blk * hkv * (d + dv) * es
        for i in range(C):
            flops += min(off + i + 1, kv_len) * hq * 2 * (d + dv)
    return _bound(nbytes, flops, dname)


def _repeat_check(torch, name: str, fn):
    """Two calls of ``fn`` give equal bits; returns the first output."""
    once, twice = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(once, twice):
        raise AssertionError(f"{name}: two calls gave other bits")
    return once


def k1_cases(torch, flush):
    """K1 at the megastep's buckets (b = 8 rows, C in {1, 8, 32, 64, 256}),
    the legacy loop's prefill chunk (b = 1, C = 32, a history ending
    mid-page) and one hkv = 2 case. Each row gives the kernel's plan; each
    case is held to the walk it runs, to its twin bit for bit and to a
    second call; at C = 1, K2 at lens = cache_lens + 1 to K1 bit for bit on
    the rows with valids = 1."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref
    rows = []
    cases = [(dt, C, 1, 8, None) for dt in (torch.bfloat16, torch.float32)
             for C in (1, 8, 64, 256)] + [(torch.bfloat16, 64, 2, 8, None)]
    cases += [(torch.bfloat16, 32, 1, 8, None),
              (torch.bfloat16, 32, 1, 1, ([300], [32]))]
    for n, (dtype, C, hkv, b, fixed) in enumerate(cases):
        args = _paged_case(torch, dtype, C, hkv, seed=1000 + n, b=b,
                           rows=fixed)
        q, k, v, lens, vals, pt = args
        dname = _dname(dtype)
        plan = ops.kernel_plan(q, k, v, pt)
        name = f"K1 b={b} C={C} {dname}"
        out = _repeat_check(torch, name, lambda: ops.paged_prefill_attention(
            *args, pairing="g_major"))
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        twin = ops.paged_prefill_attention_contig(q, kg.contiguous(),
                                                  vg.contiguous(), lens,
                                                  vals, pt, pairing="g_major")
        torch.cuda.synchronize()
        if not torch.equal(out, twin):
            raise AssertionError(f"{name}: paged kernel != its "
                                 "gathered-view twin bit for bit")
        case = {"b": b, "C": C, "hkv": hkv, "pairing": "g_major", **plan,
                "bitwise_twin": True, "bitwise_repeat": True}
        if C == 1:
            k2 = ops.paged_attention(q, k, v, lens + 1, pt,
                                     pairing="g_major")
            torch.cuda.synchronize()
            one = vals == 1
            if not torch.equal(out[one], k2[one]):
                raise AssertionError(f"{name}: K2 at lens = cache_lens + 1 "
                                     "!= K1 bit for bit on valids = 1 rows")
            case["k2_equals_k1_rows"] = int(one.sum())
        g = q.shape[2] // hkv
        mask = ref._mixed_mask(C, kg.shape[1], lens, vals)[:, None]
        qs, ks, vs = q.transpose(1, 2), _tile_heads(kg, g), _tile_heads(vg, g)
        row = measure(
            torch, flush, "K1", case, dname,
            lambda: ops.paged_prefill_attention(*args, pairing="g_major"),
            lambda: ref.paged_prefill_attention_ref(*args,
                                                    pairing="g_major"),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2),
            _prefill_bound(*args, dname))
        walk = ref.paged_prefill_attention_tiled_ref(
            q.float(), k.float(), v.float(), lens, vals, pt,
            split=plan["split"], pairing="g_major",
            p_dtype=dtype if plan["route"] == "tensor_cores" else None)
        rows.append(_walk_check(torch, "K1", row, out, walk))
    return rows


def k2_cases(torch, flush):
    """K2 at the legacy loop's decode shape: b=8 rows, lengths from 1 to
    ~900 tokens over shuffled pages."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref
    rows = []
    for n, (dtype, hkv) in enumerate([(torch.bfloat16, 1), (torch.float32, 1),
                                      (torch.bfloat16, 2)]):
        q, k, v, _, _, pt = _paged_case(torch, dtype, 1, hkv, seed=2000 + n)
        dname = _dname(dtype)
        b, _, hq, d = q.shape
        blk, dv = k.shape[1], v.shape[-1]
        g = hq // hkv
        lens = torch.tensor([1, 37, 300, 517, 640, 777, 850, 901],
                            dtype=torch.int32, device="cuda")
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        kpos = torch.arange(kg.shape[1], device="cuda")
        mask = (kpos[None, :] < lens[:, None])[:, None, None]
        ks, vs = _tile_heads(kg, g), _tile_heads(vg, g)
        es = q.element_size()
        nbytes = (q.numel() + b * hq * dv) * es + (b + pt.numel()) * 4
        flops = 0
        for r in range(b):
            L = int(lens[r])
            nbytes += -(-L // blk) * blk * hkv * (d + dv) * es
            flops += L * hq * 2 * (d + dv)
        plan = ops.kernel_plan(q, k, v, pt)
        out = _repeat_check(torch, f"K2 hkv={hkv} {dname}",
                            lambda: ops.paged_attention(q, k, v, lens, pt,
                                                        pairing="g_major"))
        row = measure(
            torch, flush, "K2", {"b": b, "hkv": hkv, "pairing": "g_major",
                                 "max_len": int(lens.max()), **plan,
                                 "bitwise_repeat": True}, dname,
            lambda: ops.paged_attention(q, k, v, lens, pt,
                                        pairing="g_major"),
            lambda: ref.paged_attention_ref(q[:, 0], k, v, lens, pt,
                                            pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname))
        walk = ref.paged_attention_split_ref(
            q[:, 0].float(), k.float(), v.float(), lens, pt,
            split=plan["split"], pairing="g_major")
        rows.append(_walk_check(torch, "K2", row, out[:, 0], walk))
    return rows


def k3_cases(torch, flush):
    """K3 at the dense engine's prefill lengths (byte prompts of up to 96
    tokens, a ragged 33) and beyond, at gemma-2b heads; one hkv=2 case
    (chatglm3-6b's grouping at its head_dim), one dv != d case (the MLA
    shapes: qk 192, v 128), and the hybrid's shared block in ``forward``
    (zamba2-7b: hq = hkv = 32, d = 112, sq = 512)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    rows = []
    cases = [(dt, sq, 8, 1, 256, 256) for dt in (torch.bfloat16, torch.float32)
             for sq in (33, 96, 256)]
    cases += [(torch.bfloat16, 96, 8, 2, 128, 128),
              (torch.bfloat16, 96, 16, 16, 192, 128)]
    cases += [(dt, 512, 32, 32, 112, 112)
              for dt in (torch.bfloat16, torch.float32)]
    for n, (dtype, sq, hq, hkv, d, dv) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(3000 + n)
        q = torch.randn((1, sq, hq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((1, sq, hkv, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, sq, hkv, dv), generator=g,
                        device="cuda").to(dtype)
        dname = _dname(dtype)
        ks, vs = _tile_heads(k, hq // hkv), _tile_heads(v, hq // hkv)
        es = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + sq * hq * dv) * es
        flops = sq * (sq + 1) // 2 * hq * 2 * (d + dv)
        row = measure(
            torch, flush, "K3", {"b": 1, "sq": sq, "hq": hq, "hkv": hkv,
                                 "d": d, "dv": dv, "pairing": "g_major",
                                 **ops.launch_grid(1, sq, hq, hkv, d, dv,
                                                   dtype)},
            dname,
            lambda: ops.flash_attention(q, k, v, pairing="g_major"),
            lambda: ref.attention_ref(q, k, v, pairing="g_major"),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   is_causal=True),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname))
        walk = ref.attention_tiled_ref(
            q.float(), k.float(), v.float(), pairing="g_major",
            p_dtype=dtype if dtype == torch.bfloat16 else None)
        rows.append(_walk_check(torch, "K3", row, ops.flash_attention(
            q, k, v, pairing="g_major"), walk))
    return rows


def k4_cases(torch, flush):
    """K4 at the dense engine's decode shape: 4 slots of a 1024-token
    cache, per-row lengths from 1 up; one scalar length (the lockstep
    decode); and the hybrid's ring decode (zamba2-7b: hq = hkv = 32,
    d = 112, one row, a scalar length)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    rows = []
    gemma, ring = (4, 1024, 8, 1, 256), (1, 1024, 32, 32, 112)
    cases = [(torch.bfloat16, False, gemma), (torch.float32, False, gemma),
             (torch.bfloat16, True, gemma), (torch.bfloat16, True, ring),
             (torch.float32, True, ring)]
    for n, (dtype, scalar, (b, S, hq, hkv, d)) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(4000 + n)
        q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, S, hkv, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, S, hkv, d), generator=g, device="cuda").to(dtype)
        lens = [700] * b if scalar else [1, 97, 513, 1000]
        kv_len = 700 if scalar else torch.tensor(lens, dtype=torch.int32,
                                                 device="cuda")
        dname = _dname(dtype)
        kpos = torch.arange(S, device="cuda")
        lt = torch.tensor(lens, device="cuda")
        mask = (kpos[None, :] < lt[:, None])[:, None, None]
        ks, vs = _tile_heads(k, hq // hkv), _tile_heads(v, hq // hkv)
        es = q.element_size()
        nbytes = (q.numel() + b * hq * d) * es + b * 4
        nbytes += sum(lens) * hkv * 2 * d * es
        flops = sum(lens) * hq * 2 * 2 * d
        split, n_split = ops.kernel_plan(q, k, v)
        row = measure(
            torch, flush, "K4", {"b": b, "S": S, "hq": hq, "hkv": hkv,
                                 "d": d, "scalar_len": scalar,
                                 "lens": lens, "pairing": "g_major",
                                 "split": split, "n_split": n_split,
                                 "blocks": [n_split * hkv * b, b * hq]},
            dname,
            lambda: ops.decode_attention(q, k, v, kv_len, pairing="g_major"),
            lambda: ref.decode_attention_ref(q[:, 0], k, v, kv_len,
                                             pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname))
        once = _repeat_check(torch, f"K4 {row}", lambda: ops.decode_attention(
            q, k, v, kv_len, pairing="g_major"))
        row["bitwise_repeat"] = True
        walk = ref.decode_attention_split_ref(
            q[:, 0].float(), k.float(), v.float(), kv_len, split=split,
            pairing="g_major")
        rows.append(_walk_check(torch, "K4", row, once[:, 0], walk))
    return rows


SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _ssd_bound(b, s, h, p, g, n, L, es, init, dname) -> dict:
    """K5: x, B, C read and y written once in the compute dtype, dt, A,
    the initial state (if any) and the final state in float32; operations:
    C.B^T over the causal half once per (row, group, chunk), and per head
    M @ x over that half, C @ S, the state update, and the three products
    that make each entry of M."""
    nc = s // L
    half = L * (L + 1) // 2
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * es
    nbytes += (b * s * h + h + (2 if init else 1) * b * h * n * p) * 4
    flops = b * nc * g * half * 2 * n
    flops += b * nc * h * (half * (2 * p + 3) + 2 * 2 * L * n * p)
    return _bound(nbytes, flops, dname)


def ssd_cases(torch, flush):
    """K5 at the paths' shapes, bf16 and f32: mamba2-370m's heads at b = 4,
    s = 512 (two chunks of 256; its prefill), zamba2-7b's at b = 1, s = 512
    (its forward), a ragged single chunk (s = 100), two B/C groups, and an
    initial state. x, B and C are strided views of one conv-output-like
    tensor, as ``mamba_full`` hands them over. Each row gives the plan
    (``ops.kernel_plan``: route, grids, heads per block, splits); each case
    is held to the walk the kernels run at WALK_TOL and to a second call
    bit for bit."""
    from repro_torch.kernels.ssd import ops, ref
    rows = []
    shapes = [  # name, b, s, h, p, g, n, initial state
        ("mamba2-370m", 4, 512, 32, 64, 1, 128, False),
        ("zamba2-7b", 1, 512, 112, 64, 1, 64, False),
        ("ragged", 4, 100, 32, 64, 1, 128, False),
        ("groups2", 2, 512, 32, 64, 2, 128, False),
        ("initial_state", 4, 512, 32, 64, 1, 128, True)]
    cases = [(dt, shape) for dt in (torch.bfloat16, torch.float32)
             for shape in shapes]
    for k, (dtype, (name, b, s, h, p, g, n, init)) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(5000 + k)
        xbc = (torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                           device="cuda") * 0.5).to(dtype)
        x, B, C = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        x, B, C = (x.unflatten(-1, (h, p)), B.unflatten(-1, (g, n)),
                   C.unflatten(-1, (g, n)))
        dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.1 + 1e-3
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        st = (torch.randn((b, g, h // g, n, p), generator=gen,
                          device="cuda") * 0.5 if init else None)
        dname = _dname(dtype)
        L = min(256, s)
        plan = ops.kernel_plan(b, s, h, p, g, n, 256, dtype)

        def both():
            return torch.cat([t.float().flatten()
                              for t in ops.ssd(x, dt, A, B, C, 256, st)])

        out = _repeat_check(torch, f"K5 {name} {dname}", both)
        row = measure(
            torch, flush, "K5", {"shape": name, "b": b, "s": s, "h": h,
                                 "p": p, "g": g, "n": n, "L": L,
                                 "initial_state": init, **plan,
                                 "bitwise_repeat": True}, dname,
            lambda: ops.ssd(x, dt, A, B, C, 256, st),
            lambda: ref.ssd_chunked_ref(x, dt, A, B, C, 256, st),
            None, None,
            _ssd_bound(b, s, h, p, g, n, L, xbc.element_size(), init, dname),
            tol=SSD_TOL[dname])
        wy, wst, y_diag = ref.ssd_chunked_tiled_ref(x, dt, A, B, C, 256, st,
                                                    diag=True)
        slack = torch.cat([ref.ulp(y_diag, dtype).flatten(),
                           torch.zeros_like(wst).flatten()])
        rows.append(_walk_check(torch, "K5", row, out, torch.cat(
            [wy.flatten(), wst.flatten()]), slack))
    return rows


# ------------------------------------------------------- launch counts

def wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd import ops as ssd
    return {"K1": pa.paged_prefill_attention, "K2": pa.paged_attention,
            "K3": fa.flash_attention, "K4": da.decode_attention,
            "K5": ssd.ssd}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def _expect(path: str, counts: dict, want: dict):
    """Every kernel of the path (the keys of ``want``) launched exactly as
    often as its calls say, and at least once; the others not at all."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full or not all(want.values()):
        raise AssertionError(f"{path}: launches {counts}, expected {full}")


# ----------------------------------------------------------- main path

PROMPT_WORDS = ("plan", "tool", "call", "result", "agent", "search", "read",
                "file", "summarise", "answer", "step", "check", "memory",
                "context", "retry", "observe")


def _prompt(rng, agent: int, turn: int, n_chars: int) -> str:
    words = [PROMPT_WORDS[int(x)] for x in
             rng.integers(0, len(PROMPT_WORDS), n_chars // 4)]
    return f"agent {agent} turn {turn}: " + " ".join(words)[:n_chars]


def _n_new(agent: int) -> int:
    from repro_torch.serving.backend import _jittered_new_tokens
    return _jittered_new_tokens(NEW_TOKENS, JITTER, f"agent{agent}")


def _drive(rm, prompts) -> dict:
    """Both turns of every agent through AgentRM, a barrier between the
    turns; returns {(agent, turn): token ids}."""
    outs = {}
    try:
        for turn in range(2):
            hs = {a: rm.submit(f"agent{a}", prompts[a][turn])
                  for a in range(N_AGENTS)}
            for a, h in hs.items():
                outs[(a, turn)] = h.result(600)
    finally:
        rm.shutdown()
    return {key: [int(x) for x in s[len("tok:"):].split(",")]
            for key, s in outs.items()}


def _check_turns(path: str, toks: dict, want_len):
    if any(x < 0 for t in toks.values() for x in t):
        raise AssertionError(f"{path}: a sampled id is -1 (non-finite "
                             "logits)")
    for key, t in toks.items():
        if len(t) != want_len(key[0]):
            raise AssertionError(f"{path}: turn {key} returned {len(t)} "
                                 f"tokens, expected {want_len(key[0])}")


def _agreement(a: dict, b: dict) -> float:
    n = sum(len(t) for t in a.values())
    return sum(int(x == y) for key in a
               for x, y in zip(a[key], b[key])) / max(n, 1)


def _replay_paged(cfg, params, ekw, tokenize, prompts) -> dict:
    """A fresh paged engine on a fixed schedule: all first turns together,
    then all second turns."""
    from repro_torch.serving import PagedInferenceEngine
    eng = PagedInferenceEngine(cfg, params, **ekw)
    eng.compile_buckets()
    rids = {a: eng.submit(tokenize(prompts[a][0]), _n_new(a), retain=True)
            for a in range(N_AGENTS)}
    eng.run_to_completion(max_steps=4096)
    got = {(a, 0): list(eng.reqs[r].out_tokens) for a, r in rids.items()}
    for a, r in rids.items():
        eng.extend(r, tokenize(prompts[a][1]), _n_new(a))
    eng.run_to_completion(max_steps=4096)
    got.update({(a, 1): list(eng.reqs[r].out_tokens)
                for a, r in rids.items()})
    return got


def main_phase(torch, cfg, params, prompts, seed: int):
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.serving import PagedEngineBackend, PagedInferenceEngine

    ekw = dict(num_blocks=8 * 64 + 1, block_size=16, max_batch=8,
               max_len=1024, token_budget=256, device="cuda")
    engine = PagedInferenceEngine(cfg, params, **ekw)
    t0 = time.perf_counter()
    engine.compile_buckets()
    t_compile = time.perf_counter() - t0
    backend = PagedEngineBackend(engine, max_new_tokens=NEW_TOKENS,
                                 prompt_tokens=PROMPT_CAP,
                                 new_tokens_jitter=JITTER)
    rm = AgentRM(backend, AgentRMConfig(detect_after_s=120.0))
    engine.jit_dispatches = 0
    engine.steps_dispatched = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = _drive(rm, prompts)
    engine.sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = engine.step_stats()
    n_out = sum(len(t) for t in toks.values())
    _check_turns("main", toks, _n_new)
    if stats["jit_dispatches_per_step"] != 1.0:
        raise AssertionError(f"{stats['jit_dispatches_per_step']} "
                             "mixed_step_paged calls per step, expected 1")
    _expect("main", counts, {"K1": cfg.n_layers * stats["steps_dispatched"]})

    rep1 = _replay_paged(cfg, params, ekw, backend._tokenize, prompts)
    rep2 = _replay_paged(cfg, params, ekw, backend._tokenize, prompts)
    if rep1 != rep2:
        raise AssertionError("main: two fresh engines on one schedule "
                             "disagree")
    profile = profile_steps(torch, cfg, params, ekw, seed)
    return toks, {
        "agents": N_AGENTS, "turns": len(toks), "failed_turns": 0,
        "tokens_out": n_out, "wall_s": wall, "tokens_per_s": n_out / wall,
        "ttft_p95_s": stats["ttft_p95_s"], "itl_p95_s": stats["itl_p95_s"],
        "step_p95_s": stats["step_p95_s"],
        "steps": stats["steps_dispatched"],
        "jit_dispatches_per_step": stats["jit_dispatches_per_step"],
        "launches": counts, "n_layers": cfg.n_layers,
        "trace_buckets": stats["trace_buckets"],
        "padded_token_fraction": stats["padded_token_fraction"],
        "replay_deterministic": True,
        "agentrm_vs_replay_token_agreement": _agreement(toks, rep1),
        "profile": profile, "compile_buckets_s": t_compile,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def profile_steps(torch, cfg, params, ekw, seed: int, n_bare: int = 6,
                  n: int = 4) -> dict:
    """Where a megastep's time goes, on a full batch (8 prompts of 400
    tokens): first while the prompts prefill (the budget of 256 split over
    8 rows: C = 32), then while all rows decode (C = 1). One engine runs
    both windows bare, ``n_bare`` steps timed one by one on the host clock
    (a step ends when its ids reach the host). A second engine then runs
    the same windows under torch.profiler, ``n`` steps each; it comes
    second because the host stays slower after a profiler session has run.
    Device busy time is the profiled steps' kernel and copy time on the
    card, and the idle share holds it against the wall time of those same
    steps; the profiler slows the host, so ``profiled_over_bare`` gives
    that slowdown beside it. Host op time is the operators' own CPU time
    under the profiler; the rest of the host's share is Python between
    them."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedInferenceEngine

    def windows():
        """A fresh engine, yielded once at the start of each window."""
        eng = PagedInferenceEngine(cfg, params, **ekw)
        eng.compile_buckets()
        rng = np.random.default_rng(seed)
        for _ in range(eng.max_batch):
            eng.submit(rng.integers(1, cfg.vocab_size, 400),
                       max_new_tokens=64)
        for phase in ("prefill", "decode"):
            if phase == "decode":
                while any(r.prefilling for r in eng.active.values()):
                    eng.step()
            eng.step()
            eng.sync()
            eng.trace_buckets.clear()
            yield phase, eng

    out = {}
    for phase, eng in windows():
        bare = []
        for _ in range(n_bare):
            t0 = time.perf_counter()
            eng.step()
            bare.append((time.perf_counter() - t0) * 1e3)
        out[phase] = {"C": sorted(eng.trace_buckets), "bare_step_ms": bare,
                      "wall_ms_per_step": float(np.median(bare))}
    for phase, eng in windows():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()
            eng.sync()
            wall = (time.perf_counter() - t0) * 1e3 / n
        # device-side events only (kernels, copies, memsets): an operator's
        # own entry carries the time of the kernels it launched too
        events = prof.key_averages()
        dev = {e.key: e.self_device_time_total / 1e3 / n for e in events
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
        host = {e.key: e.self_cpu_time_total / 1e3 / n for e in events
                if e.device_type == DeviceType.CPU
                and e.self_cpu_time_total > 0}
        busy = sum(dev.values())
        if busy > wall:
            raise AssertionError(f"{phase}: device busy {busy} ms exceeds "
                                 f"the {wall} ms wall of the same steps")
        out[phase].update({
            "wall_ms_per_step_profiled": wall,
            "profiled_over_bare": wall / out[phase]["wall_ms_per_step"],
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1 - busy / wall,
            "paged_kernel_ms_per_step": sum(
                v for k, v in dev.items()
                if any(x in k for x in KERNEL_NAMES["K1"])),
            "top_device_ms_per_step": _top(dev),
            "host_op_ms_per_step": sum(host.values()),
            "top_host_op_ms_per_step": _top(host)})
    return out


def _top(times: dict, n: int = 6) -> list:
    return [[k[:60], v] for k, v in
            sorted(times.items(), key=lambda kv: -kv[1])[:n]]


def _timed_steps(eng, n: int) -> list:
    """Host ms of ``n`` steps, one by one (each ends with its tokens on the
    host)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# -------------------------------------------------------------- legacy

def legacy_phase(torch, cfg, params, prompts, mega_toks, seed: int):
    """The benchmark baseline: AgentRM's lane pool over
    SerializedPagedBackend, one turn in the engine at a time, the engine's
    legacy loop underneath."""
    import numpy as np
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.serving import (PagedInferenceEngine,
                                     SerializedPagedBackend)

    ekw = dict(num_blocks=8 * 64 + 1, block_size=16, max_batch=8,
               max_len=1024, prefill_chunk=32, megastep=False, device="cuda")
    engine = PagedInferenceEngine(cfg, params, **ekw)
    backend = SerializedPagedBackend(engine, max_new_tokens=NEW_TOKENS,
                                     prompt_tokens=PROMPT_CAP,
                                     new_tokens_jitter=JITTER)
    rm = AgentRM(backend, AgentRMConfig(detect_after_s=120.0))
    reset_counts()
    t0 = time.perf_counter()
    toks = _drive(rm, prompts)
    engine.sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = engine.step_stats()
    _check_turns("legacy", toks, _n_new)
    decode_calls = engine.decode_steps
    chunk_calls = engine.jit_dispatches - decode_calls
    _expect("legacy", counts, {"K1": cfg.n_layers * chunk_calls,
                               "K2": cfg.n_layers * decode_calls})

    def tokenize(text):
        from repro_torch.serving import byte_tokenize
        return byte_tokenize(text, cfg.vocab_size, max_len=PROMPT_CAP)

    rep1 = _replay_paged(cfg, params, ekw, tokenize, prompts)
    rep2 = _replay_paged(cfg, params, ekw, tokenize, prompts)
    if rep1 != rep2:
        raise AssertionError("legacy: two fresh engines on one schedule "
                             "disagree")
    # step times on a full batch: 8 prompts of 400 tokens, while all
    # prefill (8 chunk calls a step) and while all decode (1 call a step)
    eng = PagedInferenceEngine(cfg, params, **ekw)
    rng = np.random.default_rng(seed)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(1, cfg.vocab_size, 400), max_new_tokens=64)
    prefill_ms = _timed_steps(eng, 4)
    while any(r.prefilling for r in eng.active.values()):
        eng.step()
    eng.step()
    decode_ms = _timed_steps(eng, 6)
    n_out = sum(len(t) for t in toks.values())
    return {
        "turns": len(toks), "failed_turns": 0, "tokens_out": n_out,
        "wall_s": wall, "tokens_per_s": n_out / wall,
        "ttft_p95_s": stats["ttft_p95_s"], "itl_p95_s": stats["itl_p95_s"],
        "step_p95_s": stats["step_p95_s"],
        "steps": stats["steps_dispatched"], "chunk_calls": chunk_calls,
        "decode_calls": decode_calls,
        "jit_dispatches_per_step": stats["jit_dispatches_per_step"],
        "launches": counts, "replay_deterministic": True,
        "agentrm_vs_replay_token_agreement": _agreement(toks, rep1),
        "replay_vs_megastep_token_agreement": _agreement(rep1, mega_toks),
        "prefill_window_step_ms": prefill_ms,
        "prefill_window_median_ms": float(np.median(prefill_ms)),
        "decode_window_step_ms": decode_ms,
        "decode_window_median_ms": float(np.median(decode_ms)),
    }


# --------------------------------------------------------------- dense

def dense_phase(torch, cfg, params, prompts):
    """AgentRM's lane pool over EngineBackend and the dense slot engine:
    one prefill per turn (K3), one decode step per token (K4)."""
    import numpy as np
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.serving import EngineBackend, InferenceEngine

    ekw = dict(max_slots=4, max_len=1024, device="cuda")
    engine = InferenceEngine(cfg, params, **ekw)
    submitted = []
    submit = engine.submit

    def recording_submit(prompt, max_new_tokens=16):
        submitted.append(np.asarray(prompt, np.int32))
        return submit(prompt, max_new_tokens=max_new_tokens)

    engine.submit = recording_submit
    rm = AgentRM(EngineBackend(engine, max_new_tokens=NEW_TOKENS),
                 AgentRMConfig(detect_after_s=120.0))
    reset_counts()
    t0 = time.perf_counter()
    toks = _drive(rm, prompts)
    engine.sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _check_turns("dense", toks, lambda a: NEW_TOKENS)
    decode_steps = engine.steps_dispatched
    prefills = engine.jit_dispatches - decode_steps
    if prefills != len(toks):
        raise AssertionError(f"dense: {prefills} prefills for {len(toks)} "
                             "turns")
    _expect("dense", counts, {"K3": cfg.n_layers * prefills,
                              "K4": cfg.n_layers * decode_steps})

    def replay():
        eng = InferenceEngine(cfg, params, **ekw)
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in submitted]
        done = {r.rid: r.out_tokens for r in eng.run_to_completion()}
        return [done[r] for r in rids]

    rep1, rep2 = replay(), replay()
    if rep1 != rep2:
        raise AssertionError("dense: two fresh engines disagree")
    # the AgentRM run's turns, as a multiset, against the replay's (which
    # turn a lane served first is not fixed)
    same = sorted(map(tuple, toks.values())) == sorted(map(tuple, rep1))
    # step times with all 4 slots busy: the step that admits them (4
    # prefills of 96 tokens + 1 decode), then decode steps
    eng = InferenceEngine(cfg, params, **ekw)
    rng = np.random.default_rng(0)
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(1, cfg.vocab_size, 96), max_new_tokens=64)
    admit_ms = _timed_steps(eng, 1)[0]
    decode_ms = _timed_steps(eng, 8)
    profile = _profile_calls(torch, eng.step, n=4)
    n_out = sum(len(t) for t in toks.values())
    return {
        "turns": len(toks), "failed_turns": 0, "tokens_out": n_out,
        "wall_s": wall, "tokens_per_s": n_out / wall,
        "prompt_tokens": [len(p) for p in submitted],
        "prefills": prefills, "decode_steps": decode_steps,
        "launches": counts, "replay_deterministic": True,
        "agentrm_turns_equal_replay": same,
        "admit_step_ms": admit_ms, "decode_step_ms": decode_ms,
        "decode_median_ms": float(np.median(decode_ms)),
        "profile_decode_step": profile,
    }


# ------------------------------------------------------------ lockstep

def lockstep_phase(torch, seed: int, b: int = 2, s: int = 64):
    """test_decode_matches_full_forward at full width on the card, f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.transformer import init_params

    cfg = get_config("gemma-2b").replace(compute_dtype="float32")
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                         device="cuda", dtype=torch.int32)
    reset_counts()
    t0 = time.perf_counter()
    ref = model.forward(params, toks)                    # (b, s+1, V)
    state = model.init_decode_state(b, s + 4, device="cuda")
    for t in range(s):
        logits = model.decode_step(params, state, toks[:, t:t + 1], t)
    state2 = model.init_decode_state(b, s + 4, device="cuda")
    last = model.prefill(params, toks[:, :s], state=state2)
    nxt = model.decode_step(params, state2, toks[:, s:s + 1], s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _expect("lockstep", counts, {"K3": cfg.n_layers * 2,
                                 "K4": cfg.n_layers * (s + 1)})
    errs = {}
    for name, got, want in (("decode_vs_forward", logits[:, 0],
                             ref[:, s - 1]),
                            ("prefill_vs_forward", last[:, 0],
                             ref[:, s - 1]),
                            ("prefill_decode_vs_forward", nxt[:, 0],
                             ref[:, s])):
        errs[name] = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=LOCKSTEP_TOL,
                              rtol=LOCKSTEP_TOL):
            raise AssertionError(f"lockstep {name}: max_abs_err "
                                 f"{errs[name]} beyond {LOCKSTEP_TOL}")
    if not torch.equal(nxt[:, 0].argmax(-1), ref[:, s].argmax(-1)):
        raise AssertionError("lockstep: prefill + decode_step picks another "
                             "next token than forward")
    return {"b": b, "s": s, "dtype": "float32", "tol": LOCKSTEP_TOL,
            "max_abs_err": errs, "next_token_equal": True,
            "launches": counts, "wall_s": wall,
            "logit_abs_max": ref.abs().max().item()}


# ----------------------------------------------------------------- ssm

def _profile_calls(torch, fn, n: int = 2) -> dict:
    """Where ``n`` calls of ``fn`` spend their time, under torch.profiler
    after one warm call: the calls' wall ms (the profiler slows the host),
    the device's busy ms per call (kernels, copies, memsets) and its idle
    share of that wall, the device ms of K1-K5 per call, and the
    top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev = {e.key: e.self_device_time_total / 1e3 / n
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0}
    shared = [k for k in dev if sum(any(x in k for x in names)
                                    for names in KERNEL_NAMES.values()) > 1]
    if shared:
        raise AssertionError(f"{shared}: K1 at C = 1 and K2 run one kernel; "
                             "a profile cannot tell their shares apart")
    busy = sum(dev.values())
    return {"wall_ms_profiled": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall,
            "kernel_ms": {name: sum(v for k, v in dev.items()
                                    if any(x in k for x in names))
                          for name, names in KERNEL_NAMES.items()},
            "top_device_ms": _top(dev)}


def _lockstep_err(name, got, want) -> float:
    """Decode against forward at f32, within the reference's 2e-3 (atol and
    rtol); returns the max abs error."""
    import torch
    if not torch.allclose(got, want, atol=LOCKSTEP_TOL, rtol=LOCKSTEP_TOL):
        raise AssertionError(f"{name}: max_abs_err "
                             f"{(got - want).abs().max().item()} beyond "
                             f"{LOCKSTEP_TOL}")
    return (got - want).abs().max().item()


def _greedy(model, params, toks, steps: int):
    """prefill of ``toks`` (b, s) then ``steps`` greedy decode_steps;
    returns (ids (b, 1 + steps) on the host, prefill ms, decode step ms)."""
    import numpy as np
    import torch
    b, s = toks.shape
    state = model.init_decode_state(b, s + steps, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = model.prefill(params, toks, state=state)
    tok = last[:, -1].argmax(-1).to(torch.int32)[:, None]
    ids = [tok.cpu()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        logits = model.decode_step(params, state, tok, s + t)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        ids.append(tok.cpu())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(torch.isfinite(x).all() for x in (last, logits)):
        raise AssertionError("greedy decode: non-finite logits")
    return np.concatenate([x.numpy() for x in ids], 1), prefill_ms, step_ms


def ssm_phase(torch, seed: int, b: int = 4, s: int = 512, steps: int = 32):
    """Full-width, full-depth mamba2-370m (48 Mamba-2 layers, random
    weights from ``seed``), served as the reference serves an SSM: bf16
    ``prefill`` of b prompts (K5 in every layer), then greedy lockstep
    ``decode_step``s; a replay gives the same tokens. Then f32, b = 2:
    ``forward`` over s tokens against ``decode_step`` fed token by token,
    and ``prefill`` of chunk - 1 tokens (255) + one ``decode_step`` against
    ``forward`` over a whole chunk."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.transformer import init_params

    cfg = get_config("mamba2-370m")
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ids, prefill_ms, step_ms = _greedy(model, params, toks, steps)
    wall = time.perf_counter() - t0
    counts = read_counts()
    _expect("ssm", counts, {"K5": cfg.n_layers})
    ids2, prefill2_ms, step2_ms = _greedy(model, params, toks, steps)
    if not np.array_equal(ids, ids2):
        raise AssertionError("ssm: a replay of prefill + greedy decode "
                             "gave other tokens")
    peak_bf16 = torch.cuda.max_memory_allocated() / 1e9
    state = model.init_decode_state(b, s + 1, device="cuda")
    profile = {"prefill": _profile_calls(
        torch, lambda: model.prefill(params, toks, state=state)),
        "decode_step": _profile_calls(
            torch, lambda: model.decode_step(params, state, toks[:, :1], s),
            n=4)}
    del params, state

    cfg32 = cfg.replace(compute_dtype="float32")
    model32 = build(cfg32)
    params = init_params(cfg32, generator=g, device="cuda")
    b32 = 2
    toks = torch.randint(0, cfg.vocab_size, (b32, s), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ref = model32.forward(params, toks)                     # (b, s, V)
    state = model32.init_decode_state(b32, s, device="cuda")
    dec_err = 0.0
    for t in range(s):
        logits = model32.decode_step(params, state, toks[:, t:t + 1], t)
        dec_err = max(dec_err, _lockstep_err(f"ssm f32 position {t}",
                                             logits[:, 0], ref[:, t]))
    split = min(s, cfg.ssm.chunk) - 1     # a prompt within one chunk
    ref_p = model32.forward(params, toks[:, :split + 1])
    state = model32.init_decode_state(b32, split + 1, device="cuda")
    last = model32.prefill(params, toks[:, :split], state=state)
    nxt = model32.decode_step(params, state, toks[:, split:split + 1], split)
    torch.cuda.synchronize()
    counts32 = read_counts()
    # K5 ran in the two forwards and the prefill, in every layer
    _expect("ssm f32", counts32, {"K5": cfg.n_layers * 3})
    errs = {"decode_vs_forward_all_positions": dec_err,
            "prefill_vs_forward": _lockstep_err(
                "ssm f32 prefill", last[:, 0], ref_p[:, split - 1]),
            "prefill_decode_vs_forward": _lockstep_err(
                "ssm f32 prefill + decode", nxt[:, 0], ref_p[:, split])}
    if not torch.equal(nxt[:, 0].argmax(-1), ref_p[:, split].argmax(-1)):
        raise AssertionError("ssm f32: prefill + decode_step picks another "
                             "next token than forward")
    n_out = b * (1 + steps)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "b": b,
            "prompt_tokens": s, "decode_steps": steps, "dtype": "bfloat16",
            "launches": {k: counts[k] + counts32[k] for k in counts},
            "launches_bf16_serving": counts,
            "prefill_ms": [prefill_ms, prefill2_ms],
            "decode_step_median_ms": [float(np.median(step_ms)),
                                      float(np.median(step2_ms))],
            "output_tokens_per_s": n_out / wall,
            "replay_deterministic": True,
            "peak_mem_gb_bf16": peak_bf16, "profile": profile,
            "f32": {"b": b32, "s": s, "prefill_split": split,
                    "tol": LOCKSTEP_TOL,
                    "max_abs_err": errs, "next_token_equal": True,
                    "logit_abs_max": ref.abs().max().item(),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}


# -------------------------------------------------------------- hybrid

def hybrid_phase(torch, seed: int, s: int = 512, steps: int = 32,
                 n_fwd: int = 2):
    """Full-width zamba2-7b (d_model 3584, 32 heads of 112, d_in 7168,
    d_state 64, random weights from ``seed``) in bf16 at full depth (81
    layers: 13 groups of [shared block, 6 Mamba-2 layers], a tail of 3):
    ``forward`` over b = 1, s tokens (K3 in each application of the shared
    block, K5 in each Mamba-2 layer), then ``decode_step`` from position 0
    (the reference's hybrid has no prefill): the first 8 prompt tokens fed,
    then greedy, ``steps`` steps in all (K4 through each ring). Then f32 at
    a depth cut to 13 layers (2 groups and a tail of 1): ``forward`` over
    64 tokens against ``decode_step`` fed token by token."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.hybrid import _layout, init_params

    cfg = get_config("zamba2-7b")
    n_groups, _, tail = _layout(cfg)
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fwd_ms = []
    for _ in range(n_fwd):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.forward(params, toks)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    if logits.shape != (1, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"hybrid forward: shape {tuple(logits.shape)} "
                             "or non-finite logits")
    state = model.init_decode_state(1, steps, device="cuda")
    tok, ids, step_ms = toks[:, :1], [], []
    for t in range(steps):
        t0 = time.perf_counter()
        out = model.decode_step(params, state, tok, t)
        nxt = out[:, -1].argmax(-1).to(torch.int32)[:, None]
        tok = toks[:, t + 1:t + 2] if t + 1 < 8 else nxt
        ids.append(int(nxt[0, 0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(out).all():
        raise AssertionError("hybrid decode: non-finite logits")
    counts = read_counts()
    _expect("hybrid", counts, {"K5": cfg.n_layers * n_fwd,
                               "K3": n_groups * n_fwd,
                               "K4": n_groups * steps})
    peak_bf16 = torch.cuda.max_memory_allocated() / 1e9
    profile = {"forward": _profile_calls(
        torch, lambda: model.forward(params, toks), n=1),
        "decode_step": _profile_calls(
            torch, lambda: model.decode_step(params, state, tok, steps - 1),
            n=4)}
    del params, state

    cfg32 = cfg.replace(compute_dtype="float32", n_layers=13)
    g32, _, tail32 = _layout(cfg32)
    model32 = build(cfg32)
    params = init_params(cfg32, generator=g, device="cuda")
    b32, s32 = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (b32, s32), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ref = model32.forward(params, toks)
    state = model32.init_decode_state(b32, s32, device="cuda")
    err = 0.0
    for t in range(s32):
        out = model32.decode_step(params, state, toks[:, t:t + 1], t)
        err = max(err, _lockstep_err(f"hybrid f32 position {t}", out[:, 0],
                                     ref[:, t]))
    torch.cuda.synchronize()
    counts32 = read_counts()
    _expect("hybrid f32", counts32, {"K5": cfg32.n_layers, "K3": g32,
                                     "K4": g32 * s32})
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "groups": n_groups,
            "tail": tail, "b": 1, "s": s, "dtype": "bfloat16",
            "init_s": t_init, "forward_ms": fwd_ms,
            "forward_tokens_per_s": s / (min(fwd_ms) / 1e3),
            "decode_steps": steps,
            "decode_step_median_ms": float(np.median(step_ms)),
            "decode_tokens_per_s": 1e3 / float(np.median(step_ms)),
            "greedy_ids": ids,
            "launches": {k: counts[k] + counts32[k] for k in counts},
            "launches_bf16": counts, "peak_mem_gb_bf16": peak_bf16,
            "profile": profile,
            "f32": {"reduced": "n_layers 81 -> 13 (2 groups + a tail of 1)",
                    "groups": g32, "tail": tail32, "b": b32, "s": s32,
                    "tol": LOCKSTEP_TOL,
                    "max_abs_err_decode_vs_forward_all_positions": err,
                    "logit_abs_max": ref.abs().max().item(),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}


# ----------------------------------------------------------------- run

def _kernel_name(mangled: str) -> str:
    """name<template args> of a mangled kernel: the length-prefixed
    identifier ending in _kernel (a namespace hash may hold digits just
    before its length), then its int and type arguments."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            size = int(m.group()[i:])
            ident = mangled[m.end():m.end() + size]
            if len(ident) == size and ident.endswith("_kernel"):
                rest = mangled[m.end() + size:]
                t = re.match(r"I(.*?)EEv", rest)
                targs = t.group(1) if t else ""
                ty = ("float" if targs.startswith("f") else
                      "bf16" if "bfloat16" in targs else None)
                args = ([ty] if ty else []) + re.findall(r"L[ib](\d+)E",
                                                         targs)
                return f"{ident}<{','.join(args)}>" if t else ident
    return mangled[:60]


def _ptxas(log: str) -> list:
    """ptxas's report per kernel: [name<template args>, registers, spill
    stores in bytes]."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out.append([name, None, int(m.group(1))])
        m = re.search(r"Used (\d+) registers", ln)
        if m and out and out[-1][1] is None:
            out[-1][1] = int(m.group(1))
    return out


def kernel_entry(name, rows, launches, source, replaces):
    """The kernels line's entry: the headline case's times and bound (the
    first bf16 case at the main shape), the largest bf16 error."""
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "bfloat16"),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.models.transformer import init_params

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = [pa.SOURCE, fa.SOURCE, da.SOURCE, ssd.SOURCE]
    build.build_all(sources)
    pa.load_kernel()
    pa.load_kernel("paged_decode_attention")
    fa.load_kernel()
    da.load_kernel()
    ssd.load_kernel()
    ptxas = {s.name: _ptxas(build.ptxas_log.get(s, "")) for s in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    cases = {"K1": k1_cases(torch, flush), "K2": k2_cases(torch, flush),
             "K3": k3_cases(torch, flush), "K4": k4_cases(torch, flush),
             "K5": ssd_cases(torch, flush)}
    # K1's headline is the widest bucket of the main path, C = 256
    cases["K1"].sort(key=lambda r: (r["dtype"] != "bfloat16", -r["C"]))
    # K3's the dense engine's longest prompt, sq = 96
    cases["K3"].sort(key=lambda r: (r["dtype"] != "bfloat16",
                                    r["sq"] != 96, r["hkv"] != 1))
    emit({"phase": "kernels", "cases": sum(map(len, cases.values())),
          "all_within_tol": True, "all_within_walk_tol": True,
          "bitwise_twin": True, "bitwise_repeat": True,
          "k2_equals_k1_at_c1": True})

    cfg = get_config("gemma-2b")     # full width, bf16 compute
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    prompts = [[_prompt(rng, a, t, int(rng.integers(200, 360)))
                for t in range(2)] for a in range(N_AGENTS)]

    mega_toks, main = main_phase(torch, cfg, params, prompts, args.seed)
    emit({"phase": "main", "card": smi, "init_s": t_init, **main})
    legacy = legacy_phase(torch, cfg, params, prompts, mega_toks, args.seed)
    emit({"phase": "legacy", "card": smi, **legacy})
    dense = dense_phase(torch, cfg, params, prompts)
    emit({"phase": "dense", "card": smi, **dense})
    del params
    torch.cuda.empty_cache()
    lockstep = lockstep_phase(torch, args.seed)
    emit({"phase": "lockstep", "card": smi, **lockstep})
    # the engines of the serving phases hold the gemma-2b params in
    # reference cycles: collect them, so each new phase's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    ssm = ssm_phase(torch, args.seed)
    emit({"phase": "ssm", "card": smi, **ssm})
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch, args.seed)
    emit({"phase": "hybrid", "card": smi, **hybrid})

    launches = {name: sum(p["launches"][name]
                          for p in (main, legacy, dense, lockstep, ssm,
                                    hybrid))
                for name in cases}
    src = "src/repro_torch/kernels/"
    ref = "src/repro/kernels/"
    kernels = [
        kernel_entry("paged_prefill_attention", cases["K1"], launches["K1"],
                     src + "paged_attention/csrc/paged_prefill_attention.cu",
                     ref + "paged_attention/kernel.py:180"),
        kernel_entry("paged_attention", cases["K2"], launches["K2"],
                     src + "paged_attention/csrc/paged_prefill_attention.cu",
                     ref + "paged_attention/kernel.py:227"),
        kernel_entry("flash_attention", cases["K3"], launches["K3"],
                     src + "flash_attention/csrc/flash_attention.cu",
                     ref + "flash_attention/kernel.py:71"),
        kernel_entry("decode_attention", cases["K4"], launches["K4"],
                     src + "decode_attention/csrc/decode_attention.cu",
                     ref + "decode_attention/kernel.py:59"),
        kernel_entry("ssd", cases["K5"], launches["K5"],
                     src + "ssd/csrc/ssd.cu", ref + "ssd/kernel.py:75")]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
