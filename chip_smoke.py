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
                 legacy chunk), and at C in {1, 32} llama4-scout's heads
                 (hq=40, hkv=8, d=128), starcoder2-7b's (hq=36, hkv=4)
                 and its tensor-parallel shards' (tp 2: hq=18, hkv=2;
                 tp 4: hq=9, hkv=1); bit for bit against its gathered-view twin
                 and on a second call; each row gives the kernel's route
                 (split decode at C=1: on the tensor cores in bf16, the
                 CUDA cores in f32; tensor cores at bf16 C>1, the walk
                 at f32 C>1) and its key ranges, and is held to the walk
                 it runs at a tighter tolerance; at C=1, K2 at
                 lens = cache_lens + 1 equals it bit for bit on the rows
                 with valids = 1;
              K2 paged decode: b=8, blk=16, histories up to ~900 tokens,
                 plus one hkv=2 case; the split plan, the split walk at a
                 tighter tolerance, equal bits on a second call;
              K3 flash attention: b=1, sq in {33, 96, 256}, plus one hkv=2
                 case, one dv != d case, the hybrid's heads at sq=512,
                 whisper-tiny's encoder (sq=skv=1500, d=64, not causal)
                 and cross-attention (sq=1, skv=1500), and llava-next's
                 prefix (sq=640, hq=32, hkv=8, d=128);
                 each row gives the grid, and each case is also held to
                 the tiled walk it runs (P rounded to bf16) at a tighter
                 tolerance;
              K4 decode over a contiguous cache: b=4 slots, S=1024, per-row
                 lengths from 1 up, plus one scalar-length case, the
                 hybrid's ring (b=1, S=1024) at its heads and whisper-tiny's
                 decoder (b=2, S=448, hq=hkv=6, d=64); each row gives
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
              The gradients, at the training path's shapes: K3's
              (FlashAttentionFn: the kernel with each row's log-sum-exp,
              then the FlashAttention-2 backward in torch ops) at gemma-2b's
              (b=8, sq=128; bf16 and f32), the MLA's (d=192, dv=128) and
              whisper-tiny's encoder (sq=skv=1500, not causal); K5's
              (SSDFn: the kernel, then autograd of the plain scan
              recomputed) at mamba2-370m's (b=8, s=128), bf16 and f32.
              At each of these shapes the kernel's forward output against
              the plain version and its walk, as above; dq/dk/dv (and the
              SSD inputs' gradients, which check SSDFn's wiring: its
              backward recomputes the plain scan) against autograd of the
              plain versions within 2e-2 (bf16) or 1e-4 (f32) of the
              plain gradient's largest magnitude, K3's lse against the
              plain one; each backward's device ms beside its forward's.
              The fp8 KV cache (``kv_cache_dtype="float8_e4m3fn"``): K1
              (tensor cores at C 32 and 256 and the legacy chunk, split at
              C 1, the f32 walk at C 8), K2 (bf16, f32) and K4 (per-row
              bf16 and f32, one scalar length) on e4m3 pools and caches at
              gemma-2b's heads, each against its plain version, bit for
              bit against the same kernel on the pools upcast to q's
              dtype, and timed beside that call in turns (upcast, fp8,
              fp8, upcast) with SDPA on the upcast K/V (SDPA takes no fp8
              K/V); the bound counts K/V at 1 byte an element.
4. main     — full-width gemma-2b (depth 18, random weights from --seed) in
              bf16 served through AgentRM -> PagedEngineBackend ->
              PagedInferenceEngine -> mixed_step_paged (K1): several agents,
              two turns each, prompts of a few hundred tokens, each step one
              CUDA graph replay (``compile_buckets`` captures every bucket
              width). Checks every turn completes, no id is -1, one
              mixed_step_paged call and one replay per step, K1 launches
              == n_layers x steps, that a fresh engine replaying graphs and
              one stepping eagerly (``cuda_graphs=False``) give equal
              tokens on one schedule, and profiles a prefill and a decode
              window, replayed and eager. Prints the capture seconds and
              each width's graph-pool bytes.
5. legacy   — the same agents and prompts through AgentRM ->
              SerializedPagedBackend -> PagedInferenceEngine(megastep=False)
              (K1 per prefill chunk, K2 per decode step; the decode and
              the chunk, its lengths staged on the device, each a CUDA
              graph captured at its first call). Checks every turn
              completes, the launch counts, one replay per chunk and per
              decode step after the first, graph against eager tokens on
              one schedule, and prints the replay's token agreement with
              the megastep run, both routes' step times, and one chunk's
              bare ms, replayed and eager.
6. dense    — AgentRM -> EngineBackend -> InferenceEngine (4 slots,
              max_len 1024): K3 per prefill, K4 per decode step (the
              decode a CUDA graph captured at its first call, the prefill
              one per prompt length, copied into the cache at the staged
              slot). Checks every turn completes, the launch counts, one
              replay per decode step after the first and per prefill of a
              length seen before, graph against eager tokens on one
              schedule, and profiles a decode step with all 4 slots busy
              and a prefill of 96 tokens, replayed and eager, with the
              capture seconds and graph count.
7. kv_fp8   — the fp8 KV cache at full gemma-2b (bf16 compute, e4m3
              pools and cache, the same params and agents): AgentRM over
              the megastep (K1), the legacy loop (K1, K2) and the dense
              engine (K3 on the prefill's fresh K/V, K4 on the cache), each
              captured as above. Checks every turn completes with no -1,
              the launch counts, pools and cache at half bf16's bytes;
              reports each run's token agreement with its bf16 run and
              both rates (not gated: e4m3 rounds the cached K/V). Then
              ``device.cast_to`` on the card against the CPU, bit for bit.
8. serve    — the serving CLI, ``repro_torch.launch.serve.main(argv)`` in
              this process at full gemma-2b (bf16, the CLI's defaults:
              pages of 8, 129 blocks, 4 rows, max_len 192), six runs:
              (a) --paged --token-budget 64 with a journal, a disk tier,
              a Chrome trace and a metrics dump; (b) --fleet 2 with a
              shared journal and --kill 0; (c) --fleet 2 --drain 1;
              (d) --autopilot; (e) the dense engine; (f) --paged --mesh
              tp=1 (the tensor-parallel megastep). Checks every turn
              completes (the resubmitted ones too), the kill's "lost 1"
              and the drain's "drained 1", the trace and the dump, one
              dispatch per step, and the launches: K1 = n_layers x steps
              on (a)-(d) and (f), K3 and K4 alone on (e), counted from the
              AgentRM's construction (after compile_buckets), one replay
              per step on (a), (d), (f), and per (e)'s decodes and
              prefills after each key's first. Then
              ``python -m repro_torch.launch.serve --paged --mesh tp=1``
              as a subprocess, and
              at float32, full width, the library's recovery paths against
              a run without faults: a crash restored from the journal, a
              fluid migration mid-decode, a disk-tier hibernate/wake, a
              poisoned row, and the captured megastep against the eager
              one, tokens and pools bit for bit.
9. lockstep — full-width gemma-2b in float32, b=2, s=64: ``forward`` logits
              (K3) against ``decode_step`` fed token by token at a scalar
              cache_len (K4), within 2e-3, and ``prefill`` + ``decode_step``
              against ``forward`` on the next token.
10. ssm     — full-width, full-depth mamba2-370m (48 layers) in bf16:
              ``prefill`` of 4 prompts of 512 tokens (K5 in every layer),
              32 greedy ``decode_step``s, a replay with the same tokens,
              a profiled prefill and decode step; then f32, b=2: ``forward`` over 512 tokens against
              ``decode_step`` token by token at every position, and
              ``prefill`` of 255 + one ``decode_step`` against ``forward``
              over 256, within 2e-3, the next token equal.
11. hybrid  — full-width zamba2-7b in bf16 at full depth (81 layers):
              ``forward`` over b=1, s=512 (K3 per group, K5 per Mamba-2
              layer), 32 ``decode_step``s from position 0 (K4 per group),
              a profiled forward and decode step; then f32 at a depth cut
              to 13 layers: ``forward`` over 64
              tokens against ``decode_step`` token by token, within 2e-3.
12. moe     — llama4-scout-17b-a16e (MoE: 16 experts of 8192 top-1 and a
              shared one) at full width in bf16, depth cut to 8 of 48
              layers (memory): ``main`` as it runs gemma-2b, the same
              agents and prompts through AgentRM -> the megastep (K1),
              every column of each step routed; then f32 at depth 2,
              capacity factor 8, one row: ``forward`` against
              ``decode_step`` token by token, within 2e-3.
13. mla     — deepseek-v2-lite-16b (MLA, 64 experts top-6, a dense first
              layer) at full width and depth in bf16: ``forward`` over
              2 x 512 (K3 at d 192, dv 128), ``prefill`` + 32 greedy
              ``decode_step``s (the absorbed decode: plain products) and
              a replay, a profiled forward and decode step; then f32 at
              depth 4, capacity factor 8: forward against decode.
14. vlm     — llava-next-mistral-7b at full width and depth in bf16:
              ``forward`` with 576 patch embeddings ahead of 64 tokens
              (K3), ``prefill`` with the prefix + 16 ``decode_step``s
              (K4); then the serving CLI ``--paged``, text only (K1).
15. starcoder2 — starcoder2-7b at full width and depth (hq 36 over 4 kv
              heads) through the serving CLI ``--paged`` at its defaults.
16. tp      — the tensor-parallel megastep (``mesh=make_tp_mesh(tp,
              devices=["cuda:0"] * tp)``, every shard on the card) at
              starcoder2-7b's full width and depth in bf16: ``main``'s
              AgentRM run without a mesh and at tp 1 (tokens and each
              session's live pages equal bit for bit), at tp 2 and 4
              (every turn, one call, one replay and 4 x max_batch host
              bytes a step, K1 = 32 x tp x steps; token agreement with
              tp 1 reported); at tp 2 the replayed step's tokens equal
              the eager one's; ``main``'s profile windows at tp 1, 2, 4,
              replayed and eager (K1 ms per launch; the device time of the
              per-layer sums of the attention partials, eager only);
              then f32: at a 4-layer cut, without a mesh and at tp 1, 2
              and 4, the replayed step gives the eager one's tokens and
              pages bit for bit and the mesh-less tokens, and sessions
              hibernated at tp 2 continue
              at tp 4 with them; at full depth each tp's live pages after
              the first turns lie within 1e-4 of the largest |value| of
              the mesh-less engine's.
17. encdec  — whisper-tiny at full size in bf16: ``forward`` (K3 not
              causal over 1500 encoder positions and across, causal over
              the text), ``init_cross_cache`` + 32 greedy ``decode_step``s
              (K4 self, K3 across at sq 1), a profiled decode step; then
              f32 forward against decode, within 2e-3.
18. train   — ``repro_torch.launch.train.main(argv)`` in this process,
              its step one CUDA graph (the first step its warm-up, one
              replay a step after it): gemma-2b at full width and depth
              (bf16 compute, f32 master params and AdamW moments, remat
              on), 4 steps of 8 x 128, no checkpoint: each step's loss,
              grad norm, ms and peak memory; losses finite, step 0's ce
              under log(V) + 2, K3 launched 2 x 18 x 4 times (forward and
              remat recompute). The same 4 steps driven on each route in
              turn (eager, graphs, graphs, eager) from the same params:
              losses, grad norms and final params bit for bit, each run's
              step ms, capture seconds, graph-pool bytes and peak reserved
              memory, a profiled step per route; an eager step's
              breakdown. mamba2-370m at full width and depth: 6 steps
              straight, then --fail-at 2 --save-every 3 (exit 42) and
              --resume to 6, final checkpoints equal bit for bit, K5
              launched 2 x 48 a step. Then at depth 2, one gradient each:
              wq/wk/wv and the Mamba block's in_proj get a finite non-zero
              gradient in every layer.
19. dryrun  — ``repro_torch.launch.dryrun`` against the card: (a) every
              ``iter_cells`` cell on the 16x16 and 2x16x16 production
              meshes on meta (64 ok, 16 skipped with the reference's
              reason; cells under build/dryrun/cells/); in a fresh
              process (``--dryrun-memory``: no free blocks of earlier
              phases in the allocator's cache), (b) gemma-2b on
              the 1 x 1 local mesh: the sizing's bytes of the f32 master
              params, the AdamW state and the bf16 decode state of
              decode_32k cut to 32 rows against the card's allocations,
              exactly (each tensor rounded to the allocator's 512 B);
              (c) the same decode step (K4) and a prefill of 1 x 8192
              (K3) on the card and on meta: the work counts (aten
              operations plus ``kernels/work.py``'s) and the bytes
              materialized (K4's workspace included) equal, 18 launches
              each; (d) a gemma-2b f32 checkpoint the port wrote, restored
              onto a 2 x 2 mesh whose positions are the one card: joined,
              the saved bits, each slice as ``param_pspec`` says, the
              allocated bytes the sizing's; (e) ``write_prefill`` /
              ``gather`` / ``scatter`` / ``set_pools`` on starcoder2-7b
              pools at full width, tp 1 and 2: the bits, a zero tail.

Every kernel's launch count is set to 0 just before a path is driven and
read just after; launches made to compare a kernel with its plain version
are not counted. Each phase's line carries its own seconds. Then the
``{"kernels": [...]}`` line (K1-K5, then K1, K2 and K4 on e4m3 pools,
their launches the kv_fp8 phase's), the card's nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that line is printed.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core bf16
              "float32": 67e12}         # float32 outside the tensor cores
TOL = {"bfloat16": 1e-2, "float32": 1e-5}   # atol and rtol, see _check
LOCKSTEP_TOL = 2e-3                     # test_decode_matches_full_forward's
# prefill's last logits against forward's last position, bf16: the same
# layers on the same inputs; only the f32 unembed runs over another row
# count, so another cuBLAS kernel may sum in another order
PREFILL_TOL = 1e-3
# (atol, rtol) of K1-K4 against the plain walks they run (the tiled walks
# with P rounded to bf16 on the tensor cores; the split-K decodes from the
# kernel's plan), in float32 out: a bf16 output is at most half a bf16 ulp
# (2^-8 relative) from it, K1's and K3's also moved by a rare other
# rounding of P (where a check passes it, plus one such rounding's most
# as _walk_check's slack: ``attention_tiled_ref(flip_slack=True)``)
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
# the record_function scope of the tensor-parallel megastep's per-layer
# sums (models/transformer.py), read by profile_steps
PARTIAL_SUM = "tp.partial_sum"
# the workload of the serving paths: agents, new tokens per turn (base +
# a per-agent jitter), and the prompt cap in tokens
N_AGENTS, NEW_TOKENS, JITTER, PROMPT_CAP = 6, 16, 8, 384
# the megastep engine of the main path
MEGASTEP_ENGINE = dict(num_blocks=8 * 64 + 1, block_size=16, max_batch=8,
                       max_len=1024, token_budget=256, device="cuda")


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
    """K1: q read, the K/V pages holding a key some query sees (at the
    pools' own element size: 1 byte for e4m3), out written, the row
    scalars and tables; 2*(d+dv) operations per visible key and query head
    (``work.k1_flops``, the count the wrapper adds)."""
    from repro_torch.kernels import work
    b, C, hq, d = q.shape
    blk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    es = k.element_size()
    nbytes = (q.numel() + b * C * hq * dv) * q.element_size()
    nbytes += (lens.numel() + vals.numel() + pt.numel()) * 4
    cache, valids = lens.tolist(), vals.tolist()
    for off, val in zip(cache, valids):
        kv_len = max(off + val, 1)
        hi = min(kv_len, off + C)            # last position any query sees
        pages = min(pt.shape[1], -(-hi // blk))
        nbytes += pages * blk * hkv * (d + dv) * es
    flops = work.k1_flops(cache, valids, C, hq, d, dv)
    return _bound(nbytes, flops, dname)


def _decode_bytes(q, k, lens, dv, blk: int = 1) -> int:
    """A decode's bytes (K2, K4): q read and out written at q's size, the
    K/V rows below each row's length (whole pages of ``blk``) at the
    cache's own size (1 byte for e4m3), the lengths."""
    b, _, hq, d = q.shape
    hkv = k.shape[-2]
    rows = sum(-(-n // blk) * blk for n in lens)
    return ((q.numel() + b * hq * dv) * q.element_size()
            + rows * hkv * (d + dv) * k.element_size() + b * 4)


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
    mid-page) and one hkv = 2 case, at gemma-2b's heads; and at C in
    {1, 32} at llama4-scout's heads (hq 40, hkv 8), starcoder2-7b's
    (hq 36, hkv 4) and its tensor-parallel shards' (hq 18, hkv 2; hq 9,
    hkv 1), d = 128. Each row gives the kernel's plan; each
    case is held to the walk it runs, to its twin bit for bit and to a
    second call; at C = 1, K2 at lens = cache_lens + 1 to K1 bit for bit on
    the rows with valids = 1."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref
    rows = []
    gemma = (8, 256)                     # hq, d
    cases = [(dt, C, 1, 8, None, gemma)
             for dt in (torch.bfloat16, torch.float32)
             for C in (1, 8, 64, 256)] + [(torch.bfloat16, 64, 2, 8, None,
                                           gemma)]
    cases += [(torch.bfloat16, 32, 1, 8, None, gemma),
              (torch.bfloat16, 32, 1, 1, ([300], [32]), gemma)]
    # llama4-scout's heads (g = 5) and starcoder2-7b's (g = 9), d = 128,
    # at the megastep's decode step and prefill bucket
    # and the tensor-parallel megastep's starcoder2-7b shards (tp 2:
    # hq 18 over 2 kv heads; tp 4: 9 over 1)
    cases += [(torch.bfloat16, C, hkv, 8, None, (hq, 128))
              for hq, hkv in ((40, 8), (36, 4), (18, 2), (9, 1))
              for C in (1, 32)]
    for n, (dtype, C, hkv, b, fixed, (hq, d)) in enumerate(cases):
        args = _paged_case(torch, dtype, C, hkv, seed=1000 + n, b=b, hq=hq,
                           d=d, rows=fixed)
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
        case = {"b": b, "C": C, "hq": hq, "hkv": hkv, "d": d,
                "pairing": "g_major", **plan,
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
            p_dtype=dtype if plan["route"] in ("tensor_cores", "split_mma")
            else None)
        rows.append(_walk_check(torch, "K1", row, out, walk))
    return rows


def k2_cases(torch, flush):
    """K2 at the legacy loop's decode shape: b=8 rows, lengths from 1 to
    ~900 tokens over shuffled pages."""
    import torch.nn.functional as F
    from repro_torch.kernels import work
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
        nbytes = _decode_bytes(q, k, lens.tolist(), dv, blk) \
            + pt.numel() * 4
        flops = work.k2_flops(lens.tolist(), hq, d, dv)
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
            split=plan["split"], pairing="g_major",
            p_dtype=dtype if plan["route"] == "split_mma" else None)
        rows.append(_walk_check(torch, "K2", row, out[:, 0], walk))
    return rows


def k3_cases(torch, flush):
    """K3 at the dense engine's prefill lengths (byte prompts of up to 96
    tokens, a ragged 33) and beyond, at gemma-2b heads; one hkv=2 case
    (chatglm3-6b's grouping at its head_dim), one dv != d case (the MLA
    shapes: qk 192, v 128), and the hybrid's shared block in ``forward``
    (zamba2-7b: hq = hkv = 32, d = 112, sq = 512); then, not causal,
    whisper-tiny's encoder (hq = hkv = 6, d = 64, sq = skv = 1500) and its
    cross-attention in ``forward`` (2 rows of sq = 64 text tokens against
    the 1500 encoder positions) and at a decode step (sq = 1), and causal,
    llava-next's image prefix and text in ``forward`` (sq = 576 + 64, hq
    32, hkv 8, d 128) and deepseek-v2-lite's MLA ``forward`` (2 rows of
    512, 16 heads, d 192, dv 128)."""
    import torch.nn.functional as F
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention import ops, ref
    rows = []
    cases = [(dt, 1, sq, 8, 1, 256, 256) for dt in
             (torch.bfloat16, torch.float32) for sq in (33, 96, 256)]
    cases += [(torch.bfloat16, 1, 96, 8, 2, 128, 128),
              (torch.bfloat16, 1, 96, 16, 16, 192, 128),
              (torch.bfloat16, 2, 512, 16, 16, 192, 128)]
    cases += [(dt, 1, 512, 32, 32, 112, 112)
              for dt in (torch.bfloat16, torch.float32)]
    cases = [c + (c[2], True) for c in cases]      # skv = sq, causal
    cases += [(torch.bfloat16, 1, 1500, 6, 6, 64, 64, 1500, False),
              (torch.bfloat16, 2, 64, 6, 6, 64, 64, 1500, False),
              (torch.bfloat16, 1, 1, 6, 6, 64, 64, 1500, False),
              (torch.bfloat16, 1, 640, 32, 8, 128, 128, 640, True)]
    for n, (dtype, b, sq, hq, hkv, d, dv, skv, causal) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(3000 + n)
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, skv, hkv, d), generator=g,
                        device="cuda").to(dtype)
        v = torch.randn((b, skv, hkv, dv), generator=g,
                        device="cuda").to(dtype)
        dname = _dname(dtype)
        ks, vs = _tile_heads(k, hq // hkv), _tile_heads(v, hq // hkv)
        es = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + b * sq * hq * dv) * es
        flops = work.k3_flops(b, sq, skv, hq, d, dv, causal)
        row = measure(
            torch, flush, "K3", {"b": b, "sq": sq, "skv": skv, "hq": hq,
                                 "hkv": hkv, "d": d, "dv": dv,
                                 "causal": causal, "pairing": "g_major",
                                 **ops.launch_grid(b, sq, hq, hkv, d, dv,
                                                   dtype)},
            dname,
            lambda: ops.flash_attention(q, k, v, causal=causal,
                                        pairing="g_major"),
            lambda: ref.attention_ref(q, k, v, causal=causal,
                                      pairing="g_major"),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   is_causal=causal),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname))
        walk = ref.attention_tiled_ref(
            q.float(), k.float(), v.float(), causal=causal,
            pairing="g_major",
            p_dtype=dtype if dtype == torch.bfloat16 else None)
        rows.append(_walk_check(torch, "K3", row, ops.flash_attention(
            q, k, v, causal=causal, pairing="g_major"), walk))
    return rows


def k4_cases(torch, flush):
    """K4 at the dense engine's decode shape: 4 slots of a 1024-token
    cache, per-row lengths from 1 up; one scalar length (the lockstep
    decode); the hybrid's ring decode (zamba2-7b: hq = hkv = 32,
    d = 112, one row, a scalar length); whisper-tiny's decoder
    self-attention (hq = hkv = 6, d = 64, 2 rows of its 448 positions, a
    scalar length); and llava-next's decode after its image prefix (hq 32,
    hkv 8, d 128, 2 rows of a 656-position cache: 576 + 64 + 16, a scalar
    length)."""
    import torch.nn.functional as F
    from repro_torch.kernels import work
    from repro_torch.kernels.decode_attention import ops, ref
    rows = []
    gemma, ring = (4, 1024, 8, 1, 256), (1, 1024, 32, 32, 112)
    whisper, llava = (2, 448, 6, 6, 64), (2, 656, 32, 8, 128)
    cases = [(torch.bfloat16, False, gemma), (torch.float32, False, gemma),
             (torch.bfloat16, True, gemma), (torch.bfloat16, True, ring),
             (torch.float32, True, ring), (torch.bfloat16, True, whisper),
             (torch.bfloat16, True, llava)]
    for n, (dtype, scalar, (b, S, hq, hkv, d)) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(4000 + n)
        q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, S, hkv, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, S, hkv, d), generator=g, device="cuda").to(dtype)
        length = min(700, S - 1)
        lens = [length] * b if scalar else [1, 97, 513, 1000]
        kv_len = length if scalar else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
        dname = _dname(dtype)
        kpos = torch.arange(S, device="cuda")
        lt = torch.tensor(lens, device="cuda")
        mask = (kpos[None, :] < lt[:, None])[:, None, None]
        ks, vs = _tile_heads(k, hq // hkv), _tile_heads(v, hq // hkv)
        nbytes = _decode_bytes(q, k, lens, d)
        flops = work.k4_flops(lens, hq, d, d)
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


def _ab_ms(torch, flush, fp8_fn, up_fn) -> dict:
    """The e4m3 call against the same kernel on the upcast pools, timed in
    turns (upcast, fp8, fp8, upcast) in this call: each turn's median
    device ms."""
    up = [time_ms(up_fn, 20, flush)[0]]
    f8 = [time_ms(fp8_fn, 20, flush)[0], time_ms(fp8_fn, 20, flush)[0]]
    up.append(time_ms(up_fn, 20, flush)[0])
    return {"fp8_turns_ms": f8, "upcast_turns_ms": up,
            "fp8_ms": statistics.mean(f8), "upcast_ms": statistics.mean(up)}


def kv_fp8_cases(torch, flush):
    """K1, K2 and K4 on e4m3 pools and caches (an fp8 KV cache,
    ``kv_cache_dtype="float8_e4m3fn"``) at gemma-2b's heads: K1 on the
    tensor cores at C 32 and 256 (b 8) and the legacy chunk (b 1, C 32),
    split at C 1, the f32 walk at C 8; K2 at the legacy decode (b 8,
    lengths 1-901), bf16 and f32; K4 at the dense engine's 4 slots
    (per-row lengths, bf16 and f32) and one scalar length. Each against
    its plain version (TOL), against the same kernel on the pools upcast
    to q's dtype bit for bit, and timed beside that call in turns
    (``_ab_ms``); the bound counts K/V at 1 byte an element. SDPA takes
    no fp8 K/V, so the library column is empty; SDPA on the upcast K/V is
    timed beside it."""
    import torch.nn.functional as F
    from repro_torch.device import cast_to
    from repro_torch.kernels import work
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention import ref as pref
    f8 = torch.float8_e4m3fn
    rows = []

    def run(kernel, case, dname, fn, up_fn, plain, sdpa, bound):
        name = f"{kernel} fp8 {case}"
        out, up = _repeat_check(torch, name, fn), up_fn()
        torch.cuda.synchronize()
        if not torch.equal(out, up):
            raise AssertionError(f"{name}: e4m3 pools != the upcast pools "
                                 "bit for bit")
        row = measure(torch, flush, kernel, {
            **case, "kv_dtype": "float8_e4m3fn", "bitwise_upcast": True,
            "bitwise_repeat": True}, dname, fn, plain, None, None, bound)
        row.update(_ab_ms(torch, flush, fn, up_fn),
                   sdpa_upcast_ms=time_ms(sdpa, 20, flush)[0],
                   library_note="none: SDPA takes no fp8 K/V")
        emit({"phase": "kernel_fp8", **{k: row[k] for k in (
            "kernel", "b", "C", "S", "dtype", "route", "fp8_turns_ms",
            "upcast_turns_ms", "fp8_ms", "upcast_ms", "sdpa_upcast_ms",
            "bound_ms") if k in row}})
        rows.append(row)

    k1 = [(torch.bfloat16, 32, 8, None), (torch.bfloat16, 256, 8, None),
          (torch.bfloat16, 32, 1, ([300], [32])),
          (torch.bfloat16, 1, 8, None), (torch.float32, 8, 8, None)]
    for n, (dtype, C, b, fixed) in enumerate(k1):
        q, k, v, lens, vals, pt = _paged_case(torch, dtype, C, 1,
                                              seed=5000 + n, b=b, rows=fixed)
        k8, v8 = cast_to(k, f8), cast_to(v, f8)
        ku, vu = k8.to(dtype), v8.to(dtype)
        kg, vg = pref.gather_pages(ku, pt), pref.gather_pages(vu, pt)
        mask = pref._mixed_mask(C, kg.shape[1], lens, vals)[:, None]
        qs, ks, vs = q.transpose(1, 2), _tile_heads(kg, 8), _tile_heads(vg, 8)
        dname = _dname(dtype)
        run("K1", {"b": b, "C": C, "hq": 8, "hkv": 1, "d": 256,
                   **pa.kernel_plan(q, k8, v8, pt)}, dname,
            lambda: pa.paged_prefill_attention(q, k8, v8, lens, vals, pt,
                                               pairing="g_major"),
            lambda: pa.paged_prefill_attention(q, ku, vu, lens, vals, pt,
                                               pairing="g_major"),
            lambda: pref.paged_prefill_attention_ref(
                q, k8, v8, lens, vals, pt, pairing="g_major"),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=mask),
            _prefill_bound(q, k8, v8, lens, vals, pt, dname))
    for n, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v, _, _, pt = _paged_case(torch, dtype, 1, 1, seed=5100 + n)
        k8, v8 = cast_to(k, f8), cast_to(v, f8)
        ku, vu = k8.to(dtype), v8.to(dtype)
        lens = torch.tensor([1, 37, 300, 517, 640, 777, 850, 901],
                            dtype=torch.int32, device="cuda")
        kg, vg = pref.gather_pages(ku, pt), pref.gather_pages(vu, pt)
        kpos = torch.arange(kg.shape[1], device="cuda")
        mask = (kpos[None, :] < lens[:, None])[:, None, None]
        ks, vs = _tile_heads(kg, 8), _tile_heads(vg, 8)
        dname = _dname(dtype)
        run("K2", {"b": 8, "hkv": 1, "max_len": 901,
                   **pa.kernel_plan(q, k8, v8, pt)}, dname,
            lambda: pa.paged_attention(q, k8, v8, lens, pt,
                                       pairing="g_major"),
            lambda: pa.paged_attention(q, ku, vu, lens, pt,
                                       pairing="g_major"),
            lambda: pref.paged_attention_ref(q[:, 0], k8, v8, lens, pt,
                                             pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            _bound(_decode_bytes(q, k8, lens.tolist(), 256, 16)
                   + pt.numel() * 4,
                   work.k2_flops(lens.tolist(), 8, 256, 256), dname))
    for n, (dtype, scalar) in enumerate([(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)]):
        g = torch.Generator(device="cuda").manual_seed(5200 + n)
        b, S, hq, d = 4, 1024, 8, 256
        q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(dtype)
        k8, v8 = (cast_to(torch.randn((b, S, 1, d), generator=g,
                                      device="cuda"), f8) for _ in "kv")
        ku, vu = k8.to(dtype), v8.to(dtype)
        lens = [700] * b if scalar else [1, 97, 513, 1000]
        kv_len = 700 if scalar else torch.tensor(lens, dtype=torch.int32,
                                                 device="cuda")
        kpos = torch.arange(S, device="cuda")
        mask = (kpos[None, :] < torch.tensor(lens, device="cuda")[:, None]
                )[:, None, None]
        ks, vs = _tile_heads(ku, hq), _tile_heads(vu, hq)
        split, n_split = da.kernel_plan(q, k8, v8)
        dname = _dname(dtype)
        run("K4", {"b": b, "S": S, "hq": hq, "hkv": 1, "d": d,
                   "scalar_len": scalar, "lens": lens, "split": split,
                   "n_split": n_split}, dname,
            lambda: da.decode_attention(q, k8, v8, kv_len,
                                        pairing="g_major"),
            lambda: da.decode_attention(q, ku, vu, kv_len,
                                        pairing="g_major"),
            lambda: dref.decode_attention_ref(q[:, 0], k8, v8, kv_len,
                                              pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            _bound(_decode_bytes(q, k8, lens, d),
                   work.k4_flops(lens, hq, d, d), dname))
    return rows


SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _ssd_bound(b, s, h, p, g, n, L, es, init, dname) -> dict:
    """K5: x, B, C read and y written once in the compute dtype, dt, A,
    the initial state (if any) and the final state in float32; operations:
    C.B^T over the causal half once per (row, group, chunk), and per head
    M @ x over that half, C @ S, the state update, and the three products
    that make each entry of M (``work.k5_flops``, the count the wrapper
    adds)."""
    from repro_torch.kernels import work
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * es
    nbytes += (b * s * h + h + (2 if init else 1) * b * h * n * p) * 4
    return _bound(nbytes, work.k5_flops(b, s, h, p, g, n, L), dname)


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


# ------------------------------------------------------- the gradients

GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max|err| <= tol max|ref|
LSE_TOL = {"bfloat16": 1e-5, "float32": 1e-5}    # the same, K3's lse


def _grad_check(name: str, got, want, tol: float) -> float:
    """Each gradient against the plain version's, max |err| within ``tol``
    times the plain gradient's largest magnitude; returns the worst ratio
    of the two."""
    import torch
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        ref = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        if not (err <= tol * ref) or not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}: gradient {i} {err} from the "
                                 f"plain version's, beyond {tol} x {ref}")
        worst = max(worst, err / ref)
    return worst


def k3_grad_cases(torch, flush):
    """K3's gradient (``FlashAttentionFn``: the kernel forward with each
    row's log-sum-exp, the FlashAttention-2 backward in torch ops) at the
    training path's shapes: gemma-2b's (b 8, sq 128, hq 8 over 1 kv head,
    d 256; bf16 and f32), the MLA forward's (16 heads, d 192, dv 128) and
    whisper-tiny's encoder (sq = skv = 1500, d 64, not causal). The
    kernel's output at each shape (the lse build, and the Function's, equal
    bit for bit) against ``attention_ref`` within TOL and against the walk
    it runs within WALK_TOL plus, per element, one entry of P rounded the
    other way (``attention_tiled_ref``'s flip slack: at b 8 the early
    causal rows, whose few P entries are near 1, meet such a flip beyond
    WALK_TOL's fixed part); dq, dk, dv against
    autograd of the plain ``attention_ref``, within GRAD_TOL of its largest
    magnitude; the lse against ``attention_lse_ref``. Times the forward
    (the kernel, lse written), the backward, the plain backward and SDPA's
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import backward, ops, ref
    rows = []
    cases = [("gemma-2b", torch.bfloat16, 8, 128, 8, 1, 256, 256, 128, True,
              "g_major"),
             ("gemma-2b", torch.float32, 8, 128, 8, 1, 256, 256, 128, True,
              "g_major"),
             ("mla", torch.bfloat16, 8, 128, 16, 16, 192, 128, 128, True,
              "kv_major"),
             ("whisper-encoder", torch.bfloat16, 8, 1500, 6, 6, 64, 64, 1500,
              False, "g_major")]
    for n, (name, dtype, b, sq, hq, hkv, d, dv, skv, causal,
            pairing) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(7000 + n)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, dv)
        dout = rnd(b, sq, hq, dv)
        dname = _dname(dtype)
        kw = dict(causal=causal, pairing=pairing)
        scale = 1.0 / d ** 0.5
        out, lse = ops.flash_attention_lse(q, k, v, **kw)
        lse_want = ref.attention_lse_ref(q, k, v, **kw)
        lse_err = (lse - lse_want).abs().max().item()
        if not lse_err <= LSE_TOL[dname] * lse_want.abs().max().item():
            raise AssertionError(f"K3 lse {name} {dname}: {lse_err}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        got_out = ops.flash_attention(*leaves, **kw)
        if type(got_out.grad_fn).__name__ != "FlashAttentionFnBackward":
            raise AssertionError(f"K3 {name}: output's grad_fn is "
                                 f"{got_out.grad_fn}")
        if not torch.equal(got_out.detach(), out):
            raise AssertionError(f"K3 {name} {dname}: FlashAttentionFn's "
                                 "output differs from the lse launch's")
        out_err = _check(f"K3 {name} {dname} forward", out,
                         ref.attention_ref(q, k, v, **kw), TOL[dname])
        walk, slack = ref.attention_tiled_ref(
            q.float(), k.float(), v.float(), **kw,
            p_dtype=dtype if dtype == torch.bfloat16 else None,
            flip_slack=True)
        got = torch.autograd.grad(got_out, leaves, dout)
        plain_in = [t.detach().requires_grad_() for t in (q, k, v)]
        plain_out = ref.attention_ref(*plain_in, **kw)
        want = torch.autograd.grad(plain_out, plain_in, dout,
                                   retain_graph=True)
        torch.cuda.synchronize()
        err = _grad_check(f"K3 {name} {dname}", got, want, GRAD_TOL[dname])
        g = hq // hkv
        sdpa_in = [q.transpose(1, 2), _tile_heads(k, g), _tile_heads(v, g)]
        sdpa_in = [t.detach().requires_grad_() for t in sdpa_in]
        sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=causal)
        sdpa_dout = dout.transpose(1, 2)
        fwd_ms, _ = time_ms(lambda: ops.flash_attention_lse(q, k, v, **kw),
                            10, flush)
        bwd_ms, bwd_host = time_ms(
            lambda: backward.flash_attention_backward(
                q, k, v, out, lse, dout, scale=scale, **kw), 10, flush)
        plain_ms, _ = time_ms(lambda: torch.autograd.grad(
            plain_out, plain_in, dout, retain_graph=True), 10, flush)
        lib_ms, _ = time_ms(lambda: torch.autograd.grad(
            sdpa_out, sdpa_in, sdpa_dout, retain_graph=True), 10, flush)
        es = q.element_size()
        nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * dout.numel()) * es + lse.numel() * 4
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        flops = b * pairs * hq * 2 * (3 * d + 2 * dv)
        row = {"kernel": "K3", "gradient": True, "case": name, "b": b,
               "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d, "dv": dv,
               "causal": causal, "pairing": pairing, "dtype": dname,
               "forward_max_abs_err": out_err, "forward_tol": TOL[dname],
               "max_err_over_max_ref": err, "tol": GRAD_TOL[dname],
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL[dname],
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "backward_host_ms": bwd_host, "plain_backward_ms": plain_ms,
               "library_backward_ms": lib_ms,
               **_bound(nbytes, flops, dname)}
        _walk_check(torch, "K3", row, out, walk, slack)
        emit({"phase": "kernel_grad_case", **row})
        rows.append(row)
    return rows


def ssd_grad_cases(torch, flush):
    """K5 through ``SSDFn`` (the kernel forward, the backward by autograd
    of the plain chunked scan, recomputed) at mamba2-370m's training shape
    (b 8, s 128: one chunk of 128; 32 heads of 64, d_state 128, an
    initial state), bf16 and f32, x, B and C strided views of one conv
    output as ``mamba_full`` hands them over. The kernel's y and final
    state at this shape against ``ssd_chunked_ref`` within SSD_TOL and
    against the walk it runs within WALK_TOL, as ``ssd_cases`` holds them.
    The gradients of the conv output, dt, A and the initial state against
    autograd of ``ssd_chunked_ref``, within GRAD_TOL: the backward
    recomputes that plain version, so this checks SSDFn's wiring (which
    input gets which gradient, through the strided views), not K5. Times
    the forward (K5), the backward and the plain backward."""
    from repro_torch.kernels.ssd import backward, ops, ref
    rows = []
    b, s, h, p, g, n = 8, 128, 32, 64, 1, 128
    for k, dtype in enumerate((torch.bfloat16, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(7500 + k)
        xbc0 = (torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                            device="cuda") * 0.5).to(dtype)
        dt0 = torch.rand((b, s, h), generator=gen, device="cuda") * 0.1 \
            + 1e-3
        A0 = -torch.linspace(1.0, 16.0, h, device="cuda")
        st0 = torch.randn((b, g, h // g, n, p), generator=gen,
                          device="cuda") * 0.5
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        dst = torch.randn((b, g, h // g, n, p), generator=gen, device="cuda")
        dname = _dname(dtype)

        def split(xbc):
            x, B, C = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
            return (x.unflatten(-1, (h, p)), B.unflatten(-1, (g, n)),
                    C.unflatten(-1, (g, n)))

        def grads(fn):
            leaves = [t.detach().requires_grad_()
                      for t in (xbc0, dt0, A0, st0)]
            x, B, C = split(leaves[0])
            y, state = fn(x, leaves[1], leaves[2], B, C, 256, leaves[3])
            return ((y.detach(), state.detach()), y.grad_fn,
                    torch.autograd.grad((y, state), leaves, (dy, dst)))

        out, grad_fn, got = grads(ops.ssd)
        if type(grad_fn).__name__ != "SSDFnBackward":
            raise AssertionError(f"K5: output's grad_fn is {grad_fn}")
        want_out, _, want = grads(ref.ssd_chunked_ref)
        torch.cuda.synchronize()
        out_err = _check(f"K5 {dname} forward", out, want_out,
                         SSD_TOL[dname])
        err = _grad_check(f"K5 {dname}", got, want, GRAD_TOL[dname])
        x, B, C = split(xbc0)
        wy, wst, y_diag = ref.ssd_chunked_tiled_ref(x, dt0, A0, B, C, 256,
                                                    st0, diag=True)
        walk = torch.cat([wy.flatten(), wst.flatten()])
        slack = torch.cat([ref.ulp(y_diag, dtype).flatten(),
                           torch.zeros_like(wst).flatten()])
        fwd_ms, _ = time_ms(lambda: ops.ssd(x, dt0, A0, B, C, 256, st0), 10,
                            flush)
        bwd_ms, bwd_host = time_ms(lambda: backward.ssd_backward(
            x, dt0, A0, B, C, 256, st0, dy, dst), 10, flush)
        plain_in = [t.detach().requires_grad_() for t in (xbc0, dt0, A0, st0)]
        px, pB, pC = split(plain_in[0])
        pout = ref.ssd_chunked_ref(px, plain_in[1], plain_in[2], pB, pC, 256,
                                   plain_in[3])
        plain_ms, _ = time_ms(lambda: torch.autograd.grad(
            pout, plain_in, (dy, dst), retain_graph=True), 10, flush)
        es = xbc0.element_size()
        fwd = _ssd_bound(b, s, h, p, g, n, s, es, True, dname)
        # the gradient: x, B, C, dt, A and the initial state read, and a
        # gradient of each written; dy and dstate read; the products of
        # the forward's autodiff, two for each of its own
        ins = (b * s * h * p + 2 * b * s * g * n) * es \
            + (b * s * h + h + b * h * n * p) * 4
        bound = _bound(2 * ins + b * s * h * p * es + b * h * n * p * 4,
                       2 * fwd["flops"], dname)
        row = {"kernel": "K5", "gradient": True, "case": "mamba2-370m",
               "b": b, "s": s, "h": h, "p": p, "g": g, "n": n, "L": s,
               "initial_state": True, "dtype": dname,
               "forward_max_abs_err": out_err,
               "forward_tol": SSD_TOL[dname],
               "max_err_over_max_ref": err, "tol": GRAD_TOL[dname],
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "backward_host_ms": bwd_host, "plain_backward_ms": plain_ms,
               "library_backward_ms": None, **bound}
        _walk_check(torch, "K5", row, torch.cat(
            [out[0].float().flatten(), out[1].flatten()]), walk, slack)
        emit({"phase": "kernel_grad_case", **row})
        rows.append(row)
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


def make_prompts(seed: int) -> list:
    """Two turns' prompts for each of the N_AGENTS agents, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[_prompt(rng, a, t, int(rng.integers(200, 360)))
             for t in range(2)] for a in range(N_AGENTS)]


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


def _tokenize(cfg, text: str):
    """A prompt as the main path's backend tokenizes it."""
    from repro_torch.serving import byte_tokenize
    return byte_tokenize(text, cfg.vocab_size, max_len=PROMPT_CAP)


def _replay_paged(cfg, params, ekw, tokenize, prompts, pages=False):
    """A fresh paged engine on a fixed schedule: all first turns together,
    then all second turns. Returns the tokens, and with ``pages`` also the
    sessions' live pages (``_live_pages``)."""
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
    return (got, _live_pages(eng)) if pages else got


def _graphs_vs_eager(path: str, cfg, params, ekw, tokenize, prompts,
                     pools_gate: bool) -> dict:
    """``_replay_paged`` with the captured megastep (the default) and with
    the eager one (``cuda_graphs=False``): two fresh engines on one
    schedule. Their tokens must be equal, and with ``pools_gate`` (f32)
    the sessions' live pages bit for bit; otherwise whether the pages are
    equal is reported. Returns the graph run's tokens and the reading."""
    got, got_pages = _replay_paged(cfg, params, ekw, tokenize, prompts,
                                   pages=True)
    want, want_pages = _replay_paged(cfg, params,
                                     {**ekw, "cuda_graphs": False},
                                     tokenize, prompts, pages=True)
    err = _pages_err(got_pages, want_pages)
    if got != want or (pools_gate and err != 0):
        raise AssertionError(f"{path}: graph replay against the eager "
                             f"step: token agreement {_agreement(got, want)}"
                             f", pages {err} apart")
    return got, {"graph_vs_eager_tokens_equal": True,
                 "graph_vs_eager_pages_max_abs_diff": err}


def _graph_window(path: str, eng, before: dict, steps: int) -> dict:
    """The captured steps of one engine over a counted window: ``before``
    is its ``graph_stats()`` at the window's start. Every step of the
    window is one replay (a key first met in the window runs its warm-up
    step eagerly, then replays); replays per step is then 1 over the
    steps after those first calls. Also the seconds its captures took and
    each key's graph-pool bytes."""
    st = eng.graph_stats()
    if not st["cuda_graphs"]:
        raise AssertionError(f"{path}: the graph route is off")
    replays = st["replays"] - before.get("replays", 0)
    first = st["first_calls"] - before.get("first_calls", 0)
    if replays + first != steps or replays < 1:
        raise AssertionError(f"{path}: {replays} replays and {first} "
                             f"first calls over {steps} graph steps")
    return {"replays": replays, "first_calls_in_window": first,
            "replays_per_step": replays / (steps - first),
            "capture_s": st["capture_s"], "graphs": st["graphs"],
            "pool_growth_bytes": st["pool_growth_bytes"]}


def main_phase(torch, cfg, params, prompts, seed: int):
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.serving import PagedEngineBackend, PagedInferenceEngine

    ekw = MEGASTEP_ENGINE
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
    g0 = engine.graph_stats()
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
    graph = _graph_window("main", engine, g0, stats["steps_dispatched"])
    if graph["first_calls_in_window"]:
        raise AssertionError("main: a width was captured mid-traffic, "
                             "after compile_buckets")

    # two fresh engines on one schedule, the captured step and the eager
    # one: equal tokens (the bf16 pages' equality reported)
    rep1, versus = _graphs_vs_eager("main", cfg, params, ekw,
                                    backend._tokenize, prompts, False)
    profile = {"graphs": profile_steps(torch, cfg, params, ekw, seed),
               "eager": profile_steps(torch, cfg, params,
                                      {**ekw, "cuda_graphs": False}, seed)}
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
        "graph": graph, **versus, "replay_deterministic": True,
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
    ``ekw`` picks the captured step (the default) or the eager one
    (``cuda_graphs=False``); under a replay the profiler sees the kernels
    but no operator's host events, so the host op time is the replay's
    own and a record_function scope (``tp.partial_sum``) reads 0.
    Device busy time is the profiled steps' kernel and copy time on the
    card, and the idle share holds it against the wall time of those same
    steps; the profiler slows the host, so ``profiled_over_bare`` gives
    that slowdown beside it. Host op time is the operators' own CPU time
    under the profiler; the rest of the host's share is Python between
    them."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def windows():
        return step_windows(cfg, params, ekw, seed)

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
               and e.self_device_time_total > 0 and e.key != PARTIAL_SUM}
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
            # the tensor-parallel megastep's per-layer sums of the
            # attention partials: the kernels under their record_function
            # scope (its host-side events; the device-side annotation
            # spans the launch gaps between them too)
            "partial_sum_ms_per_step": sum(
                e.device_time_total for e in prof.events()
                if e.name == PARTIAL_SUM
                and e.device_type == DeviceType.CPU) / 1e3 / n,
            "top_device_ms_per_step": _top(dev),
            "host_op_ms_per_step": sum(host.values()),
            "top_host_op_ms_per_step": _top(host)})
    return out


def step_windows(cfg, params, ekw, seed: int):
    """A fresh megastep engine with a full batch (8 prompts of 400 tokens),
    yielded once at the start of each window: while the prompts prefill
    (C = 32), then while all rows decode (C = 1)."""
    import numpy as np
    from repro_torch.serving import PagedInferenceEngine
    eng = PagedInferenceEngine(cfg, params, **ekw)
    eng.compile_buckets()
    rng = np.random.default_rng(seed)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(1, cfg.vocab_size, 400), max_new_tokens=64)
    for phase in ("prefill", "decode"):
        if phase == "decode":
            while any(r.prefilling for r in eng.active.values()):
                eng.step()
        eng.step()
        eng.sync()
        eng.trace_buckets.clear()
        yield phase, eng


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


def _call_ms(fn, n: int = 8) -> list:
    """Host ms of ``n`` calls of ``fn``, one by one after one warm call
    (on the graph route the key's capture), each ending with what it
    reads back on the host."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _dispatch_readings(torch, engines: dict, call,
                       profile: bool = True) -> dict:
    """One dispatch's bare ms (``_call_ms``) and, with ``profile``, a
    profile of it (``_profile_calls``), on each route's engine:
    ``engines`` {route: engine}, ``call(eng)`` the dispatch as a function
    of nothing that ends with its result on the host."""
    import numpy as np
    out = {}
    for route, eng in engines.items():
        fn = call(eng)
        ms = _call_ms(fn)
        out[route] = {"bare_ms": ms, "bare_median_ms": float(np.median(ms))}
        if profile:
            out[route]["profile"] = _profile_calls(torch, fn, n=4)
    return out


def _legacy_chunk(eng, cache_len: int = 160):
    """The legacy loop's chunk dispatch as ``_step_legacy`` makes it: a
    full chunk after ``cache_len`` tokens, its last position's logits
    read back. The table is all null blocks: the writes land in the
    reserved null block, no session's pages are touched."""
    import numpy as np
    C = eng.prefill_chunk
    ins = {"toks": np.arange(1, C + 1, dtype=np.int32)[None],
           "cache_len": np.array([cache_len], np.int32),
           "valid": np.array([C], np.int32),
           "table": np.zeros((eng.max_pages,), np.int32)}
    return lambda: eng._dispatch(("chunk", C), eng._chunk, ins)[
        0, C - 1].cpu()


def _dense_prefill(eng, plen: int = 96):
    """The dense engine's prefill dispatch as ``_admit`` makes it: one
    prompt of ``plen`` tokens into slot 0, its argmax read back."""
    import numpy as np
    ins = {"toks": (np.arange(plen, dtype=np.int32) % 97 + 1)[None],
           "slot": np.zeros((1,), np.int32)}
    return lambda: int(eng._dispatch(("prefill", plen), eng._prefill,
                                     ins)[0, -1].argmax())


# -------------------------------------------------------------- legacy

def legacy_phase(torch, cfg, params, prompts, mega_toks, seed: int):
    """The benchmark baseline: AgentRM's lane pool over
    SerializedPagedBackend, one turn in the engine at a time, the engine's
    legacy loop underneath. Returns the AgentRM run's tokens and the
    phase's row."""
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
    g0 = engine.graph_stats()
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
    # the decode and the chunk (one width) are each captured at their
    # first call: every later chunk and decode is one replay
    graph = _graph_window("legacy", engine, g0, decode_calls + chunk_calls)
    if set(engine.graphs.steps) != {"decode",
                                    ("chunk", ekw["prefill_chunk"])}:
        raise AssertionError(f"legacy: captured {set(engine.graphs.steps)}")

    rep1, versus = _graphs_vs_eager("legacy", cfg, params, ekw,
                                    lambda text: _tokenize(cfg, text),
                                    prompts, False)
    # step times on a full batch: 8 prompts of 400 tokens, while all
    # prefill (8 chunk calls a step) and while all decode (1 call a step),
    # with the captured decode and with the eager one
    windows, engines = {}, {}
    for route, graphs_on in (("graphs", True), ("eager", False)):
        eng = engines[route] = PagedInferenceEngine(
            cfg, params, **ekw, cuda_graphs=graphs_on)
        rng = np.random.default_rng(seed)
        for _ in range(eng.max_batch):
            eng.submit(rng.integers(1, cfg.vocab_size, 400),
                       max_new_tokens=64)
        prefill_ms = _timed_steps(eng, 4)
        while any(r.prefilling for r in eng.active.values()):
            eng.step()
        eng.step()
        decode_ms = _timed_steps(eng, 6)
        windows[route] = {
            "prefill_window_step_ms": prefill_ms,
            "prefill_window_median_ms": float(np.median(prefill_ms)),
            "decode_window_step_ms": decode_ms,
            "decode_window_median_ms": float(np.median(decode_ms))}
    # one chunk alone (b 1, C 32, after 160 tokens), replayed and eager;
    # not profiled: K1 splits the chunk's keys here and merges them with
    # the kernel K2 merges with, which a profile cannot attribute
    chunk = _dispatch_readings(torch, engines, _legacy_chunk,
                               profile=False)
    n_out = sum(len(t) for t in toks.values())
    return toks, {
        "turns": len(toks), "failed_turns": 0, "tokens_out": n_out,
        "wall_s": wall, "tokens_per_s": n_out / wall,
        "ttft_p95_s": stats["ttft_p95_s"], "itl_p95_s": stats["itl_p95_s"],
        "step_p95_s": stats["step_p95_s"],
        "steps": stats["steps_dispatched"], "chunk_calls": chunk_calls,
        "decode_calls": decode_calls,
        "jit_dispatches_per_step": stats["jit_dispatches_per_step"],
        "launches": counts, "graph": graph, **versus,
        "replay_deterministic": True,
        "agentrm_vs_replay_token_agreement": _agreement(toks, rep1),
        "replay_vs_megastep_token_agreement": _agreement(rep1, mega_toks),
        **windows["graphs"], "eager_windows": windows["eager"],
        "chunk": chunk,
    }


# --------------------------------------------------------------- dense

def dense_phase(torch, cfg, params, prompts):
    """AgentRM's lane pool over EngineBackend and the dense slot engine:
    one prefill per turn (K3), one decode step per token (K4). Returns the
    AgentRM run's tokens and the phase's row."""
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
    g0 = engine.graph_stats()
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
    # the decode and one prefill per prompt length, each captured at its
    # first call: every later decode, and every prefill of a length seen
    # before, is one replay
    graph = _graph_window("dense", engine, g0, decode_steps + prefills)
    lengths = sorted({len(p) for p in submitted})
    if set(engine.graphs.steps) != {"decode"} | {
            ("prefill", n) for n in lengths}:
        raise AssertionError(f"dense: captured {list(engine.graphs.steps)}"
                             f" for prompt lengths {lengths}")

    def replay(graphs_on):
        eng = InferenceEngine(cfg, params, **ekw, cuda_graphs=graphs_on)
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in submitted]
        done = {r.rid: r.out_tokens for r in eng.run_to_completion()}
        eng.sync()
        return [done[r] for r in rids], eng.state

    # two fresh engines on one schedule, the captured steps and the eager
    # ones: equal tokens (the bf16 caches' equality reported)
    (rep1, state1), (rep2, state2) = replay(True), replay(False)
    if rep1 != rep2:
        raise AssertionError("dense: the captured steps' tokens differ "
                             "from the eager one's")
    cache_diff = max((state1[n].float() - state2[n].float()).abs().max()
                     .item() for n in state1)
    del state1, state2
    # the AgentRM run's turns, as a multiset, against the replay's (which
    # turn a lane served first is not fixed)
    same = sorted(map(tuple, toks.values())) == sorted(map(tuple, rep1))
    # step times with all 4 slots busy: the step that admits them (4
    # prefills of 96 tokens + 1 decode), then decode steps; with the
    # captured decode and the eager one
    timed, engines = {}, {}
    for route, graphs_on in (("graphs", True), ("eager", False)):
        eng = engines[route] = InferenceEngine(cfg, params, **ekw,
                                               cuda_graphs=graphs_on)
        rng = np.random.default_rng(0)
        for _ in range(eng.max_slots):
            eng.submit(rng.integers(1, cfg.vocab_size, 96),
                       max_new_tokens=64)
        admit_ms = _timed_steps(eng, 1)[0]
        decode_ms = _timed_steps(eng, 8)
        timed[route] = {"admit_step_ms": admit_ms,
                        "decode_step_ms": decode_ms,
                        "decode_median_ms": float(np.median(decode_ms)),
                        "profile_decode_step": _profile_calls(
                            torch, eng.step, n=4)}
    # one prefill of 96 tokens alone, replayed and eager (it overwrites
    # slot 0's rows of these engines, which serve nothing after)
    prefill = _dispatch_readings(torch, engines, _dense_prefill)
    n_out = sum(len(t) for t in toks.values())
    return toks, {
        "turns": len(toks), "failed_turns": 0, "tokens_out": n_out,
        "wall_s": wall, "tokens_per_s": n_out / wall,
        "prompt_tokens": [len(p) for p in submitted],
        "prefills": prefills, "decode_steps": decode_steps,
        "launches": counts, "graph": graph,
        "graph_vs_eager_tokens_equal": True,
        "graph_vs_eager_cache_max_abs_diff": cache_diff,
        "replay_deterministic": True,
        "agentrm_turns_equal_replay": same,
        "prompt_lengths": len(lengths),
        **timed["graphs"], "eager": timed["eager"], "prefill": prefill,
    }


# ------------------------------------------------------------- kv_fp8

def _serve_fp8(torch, path: str, engine, backend, prompts, want,
               n_new) -> tuple:
    """One AgentRM run over ``backend`` (its engine on an e4m3 cache):
    every turn complete, the launches as ``want(engine)`` says from the
    run's calls. Returns the tokens and the run's row."""
    from repro_torch.core import AgentRM, AgentRMConfig
    rm = AgentRM(backend, AgentRMConfig(detect_after_s=120.0))
    engine.jit_dispatches = 0
    engine.steps_dispatched = 0
    reset_counts()
    t0 = time.perf_counter()
    toks = _drive(rm, prompts)
    engine.sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _check_turns(path, toks, n_new)
    _expect(path, counts, want(engine))
    n_out = sum(len(t) for t in toks.values())
    row = {"turns": len(toks), "failed_turns": 0, "tokens_out": n_out,
           "wall_s": wall, "tokens_per_s": n_out / wall,
           "launches": counts, "graph": engine.graph_stats()}
    if hasattr(engine, "step_stats"):
        st = engine.step_stats()
        row.update({k: st[k] for k in ("ttft_p95_s", "itl_p95_s",
                                       "step_p95_s", "steps_dispatched",
                                       "jit_dispatches_per_step")})
    return toks, row


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kv_fp8_phase(torch, cfg, params, prompts, bf16: dict) -> dict:
    """An fp8 KV cache (``kv_cache_dtype="float8_e4m3fn"``) at full
    gemma-2b, bf16 compute, the same params and agents: AgentRM over the
    megastep (K1 on e4m3 pools), over the legacy loop (K1 and K2) and over
    the dense engine (K3 on the prefill's fresh bf16 K/V, K4 on the e4m3
    cache), each step a CUDA graph replay as on the bf16 paths. Checks
    every turn completes with no -1, the launch counts, the pools and the
    cache at half the bytes of bf16's (the same layouts on ``meta``);
    reports each run's token agreement with its bf16 run (``bf16``: the
    path's tokens and row) and both runs' rates, not gated: e4m3 rounds
    the cached K/V, so the logits move. Then the cast helper
    (``device.cast_to``) on the card against the CPU, bit for bit, on
    every bf16 bit pattern and 2^20 f32 values."""
    import numpy as np
    from repro_torch.device import cast_to
    from repro_torch.models import build
    from repro_torch.serving import (EngineBackend, InferenceEngine,
                                     PagedEngineBackend, PagedInferenceEngine,
                                     SerializedPagedBackend)
    from repro_torch.serving.paging.pool import PagedKVCache
    f8 = torch.float8_e4m3fn
    cfg8 = cfg.replace(kv_cache_dtype="float8_e4m3fn")
    L = cfg.n_layers
    legacy_kw = dict(num_blocks=8 * 64 + 1, block_size=16, max_batch=8,
                     max_len=1024, prefill_chunk=32, megastep=False,
                     device="cuda")
    out, launches = {}, collections.Counter()
    for path, ekw in (("main", MEGASTEP_ENGINE), ("legacy", legacy_kw)):
        eng = PagedInferenceEngine(cfg8, params, **ekw)
        if path == "main":
            eng.compile_buckets()
            backend = PagedEngineBackend(eng, max_new_tokens=NEW_TOKENS,
                                         prompt_tokens=PROMPT_CAP,
                                         new_tokens_jitter=JITTER)
            want = lambda e: {"K1": L * e.steps_dispatched}
        else:
            backend = SerializedPagedBackend(eng, max_new_tokens=NEW_TOKENS,
                                             prompt_tokens=PROMPT_CAP,
                                             new_tokens_jitter=JITTER)
            want = lambda e: {"K1": L * (e.jit_dispatches - e.decode_steps),
                              "K2": L * e.decode_steps}
        toks, row = _serve_fp8(torch, f"kv_fp8 {path}", eng, backend,
                               prompts, want, _n_new)
        pools = [t for s in eng.cache.pools() for t in s.values()]
        ref = PagedKVCache(cfg, ekw["num_blocks"], ekw["block_size"],
                           device="meta")
        ref_pools = [t for s in ref.pools() for t in s.values()]
        if {t.dtype for t in pools} != {f8} \
                or 2 * _nbytes(pools) != _nbytes(ref_pools) \
                or 2 * eng.cache.bytes_total != ref.bytes_total:
            raise AssertionError(f"kv_fp8 {path}: pools {_nbytes(pools)} B "
                                 f"against bf16's {_nbytes(ref_pools)} B")
        out[path] = {**row, "pool_bytes": _nbytes(pools),
                     "bf16_pool_bytes": _nbytes(ref_pools),
                     "bf16_token_agreement": _agreement(toks, bf16[path][0])}
        launches.update(row["launches"])
        del eng, backend
    eng = InferenceEngine(cfg8, params, max_slots=4, max_len=1024,
                          device="cuda")
    toks, row = _serve_fp8(
        torch, "kv_fp8 dense", eng,
        EngineBackend(eng, max_new_tokens=NEW_TOKENS), prompts,
        lambda e: {"K3": L * (e.jit_dispatches - e.steps_dispatched),
                   "K4": L * e.steps_dispatched}, lambda a: NEW_TOKENS)
    state = list(eng.state.values())
    ref_state = list(build(cfg).init_decode_state(
        4, 1024, device="meta").values())
    if {t.dtype for t in state} != {f8} \
            or 2 * _nbytes(state) != _nbytes(ref_state):
        raise AssertionError(f"kv_fp8 dense: cache {_nbytes(state)} B "
                             f"against bf16's {_nbytes(ref_state)} B")
    out["dense"] = {**row, "cache_bytes": _nbytes(state),
                    "bf16_cache_bytes": _nbytes(ref_state),
                    "bf16_token_agreement": _agreement(toks,
                                                       bf16["dense"][0])}
    launches.update(row["launches"])
    del eng
    for name in out:
        out[name]["bf16_tokens_per_s"] = bf16[name][1]["tokens_per_s"]
    bits = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16))
    xs = {"bf16_all_patterns": bits.view(torch.bfloat16),
          "f32_random": torch.randn(1 << 20, generator=torch.Generator(
              ).manual_seed(0)) * 300}
    for name, x in xs.items():
        if not torch.equal(cast_to(x.cuda(), f8).view(torch.uint8).cpu(),
                           cast_to(x, f8).view(torch.uint8)):
            raise AssertionError(f"kv_fp8: cast_to on the card differs from "
                                 f"the CPU on {name}")
    return {"paths": out, "launches": dict(launches),
            "cast_on_card_equals_cpu": sorted(xs)}


# --------------------------------------------------------------- serve

SERVE_DIR = ROOT / "build" / "serve"     # journals, spills, trace, dump
# the serving CLI's five runs, at its own defaults (pages of 8, 129
# blocks, 4 rows, max_len 192) but at full gemma-2b; {d} is SERVE_DIR
SERVE_RUNS = {
    "a_paged": ["--paged", "--token-budget", "64", "--agents", "3",
                "--turns", "9", "--journal-dir", "{d}/a/journal",
                "--spill-dir", "{d}/a/spill", "--trace-out",
                "{d}/a/trace.json", "--metrics-dump", "{d}/a/metrics.json"],
    "b_fleet_kill": ["--paged", "--fleet", "2", "--agents", "4", "--turns",
                     "12", "--journal-dir", "{d}/b/journal", "--kill", "0"],
    "c_fleet_drain": ["--paged", "--fleet", "2", "--drain", "1"],
    "d_autopilot": ["--paged", "--autopilot"],
    "e_dense": [],
    "f_mesh_tp1": ["--paged", "--mesh", "tp=1"],
}


def _registry_q(metrics, names, suffix: str, q: float):
    """The CLI summary's quantile (``print_obs_summary``): the engines'
    histograms merged bucket-wise; None where none recorded a sample."""
    from repro_torch.obs.metrics import Histogram
    hs = [h for h in (metrics.get(f"{n}.{suffix}") for n in names)
          if h is not None and h.count]
    if not hs:
        return None
    merged = Histogram("merged", hs[0].bounds)
    for h in hs:
        merged.counts = merged.counts + h.counts
        merged.count += h.count
        merged.sum += h.sum
        merged.min = min(merged.min, h.min)
        merged.max = max(merged.max, h.max)
    return merged.quantile(q)


def _cli_run(torch, cfg, name: str, argv: list) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in this process, its stdout
    captured. The CLI builds its AgentRM once its engines are built and
    their buckets run (``compile_buckets``), so the launch counts are set
    to 0 there, and those warm-up calls are not counted; the AgentRM it
    builds is kept to read the registry and the engines afterwards."""
    import contextlib
    import io
    from repro_torch.distributed.elastic import FleetBackend
    from repro_torch.launch import serve

    seen = {}

    def engines_of(backend):
        if isinstance(backend, FleetBackend):
            return [m.backend.engine for m in backend.members]
        return [backend.engine]

    class Observed(serve.AgentRM):
        def __init__(self, backend, *a, **kw):
            if isinstance(backend, FleetBackend):
                _watch_kill(torch, backend, seen)
            seen["graphs0"] = {id(e): e.graph_stats()
                               for e in engines_of(backend)}
            reset_counts()
            seen["rm"] = self
            seen["t0"] = time.perf_counter()
            super().__init__(backend, *a, **kw)

        def shutdown(self):
            seen.setdefault("t1", time.perf_counter())
            super().shutdown()

    out = io.StringIO()
    plain = serve.AgentRM
    serve.AgentRM = Observed
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--arch", cfg.name] + argv)
    finally:
        serve.AgentRM = plain
    threads = [t.name for t in threading.enumerate()
               if t is not threading.main_thread()]
    torch.cuda.synchronize()
    counts = read_counts()
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"serve {name}: exit code {rc}")
    rm = seen["rm"]
    fleet = rm.backend if isinstance(rm.backend, FleetBackend) else None
    engines = engines_of(rm.backend)
    names = [e.name for e in engines] if fleet else ["engine"]
    turns = int(argv[argv.index("--turns") + 1]) if "--turns" in argv else 9
    served = re.findall(r"^\[serve\] agent-\d+ -> tok:", text, re.M)
    if len(served) != turns or "TIMED OUT" in text or "giving up" in text:
        raise AssertionError(f"serve {name}: {len(served)} of {turns} turns "
                             f"completed:\n{text[-3000:]}")
    m = rm.obs.metrics
    row = {"argv": argv, "turns": turns, "wall_s": seen["t1"] - seen["t0"],
           "turns_per_s": turns / (seen["t1"] - seen["t0"]),
           "engines": names, "launches": counts,
           "lost_turns_resubmitted": text.count("ENGINE LOST mid-turn")}
    if "--paged" in argv:
        steps = sum(int(m.get(f"{n}.steps_dispatched").value) for n in names)
        disp = sum(int(m.get(f"{n}.jit_dispatches").value) for n in names)
        said = re.search(r"jit dispatches (\d+) over (\d+) steps", text)
        if not (disp == steps == int(said.group(1)) == int(said.group(2))
                and steps > 0):
            raise AssertionError(f"serve {name}: {disp} dispatches over "
                                 f"{steps} steps, the summary says "
                                 f"{said.group(0)}")
        _expect(f"serve {name}", counts, {"K1": cfg.n_layers * steps})
        if fleet is None:
            # compile_buckets captured every width before the window
            row["graph"] = _graph_window(f"serve {name}", engines[0],
                                         seen["graphs0"][id(engines[0])],
                                         steps)
            if row["graph"]["first_calls_in_window"]:
                raise AssertionError(f"serve {name}: a width was captured "
                                     "mid-traffic")
        else:
            row["graph"] = {e.name: e.graph_stats() for e in engines}
        row.update(steps=steps, **{
            key: _registry_q(m, names, suffix, q) for key, suffix, q in (
                ("ttft_p95_s", "ttft_s", .95), ("itl_p95_s", "itl_s", .95),
                ("step_p50_s", "step_s", .5), ("step_p95_s", "step_s", .95))})
    else:
        decode_steps = engines[0].steps_dispatched
        prefills = engines[0].jit_dispatches - decode_steps
        if prefills != turns:
            raise AssertionError(f"serve {name}: {prefills} prefills for "
                                 f"{turns} turns")
        _expect(f"serve {name}", counts, {"K3": cfg.n_layers * prefills,
                                          "K4": cfg.n_layers * decode_steps})
        # the decodes and the prefills (one graph per prompt length)
        row["graph"] = _graph_window(f"serve {name}", engines[0],
                                     seen["graphs0"][id(engines[0])],
                                     decode_steps + prefills)
        row.update(prefills=prefills, decode_steps=decode_steps)
    if fleet is not None:
        fs = fleet.fleet_stats()
        row["fleet"] = {k: fs[k] for k in (
            "engines_active", "engines_lost", "engines_drained",
            "migrations_sudden", "migrations_fluid", "sessions_failed_over")}
        row["fleet_line"] = re.search(r"^\[serve\] fleet: .*$", text,
                                      re.M).group(0)
    for key in ("mem_before_kill", "mem_after_kill"):
        if key in seen:
            row[key] = seen[key]
    if "--autopilot" in argv:
        row["autopilot_line"] = re.search(r"^\[serve\] autopilot: .*$", text,
                                          re.M).group(0)
    row["stdout_tail"] = text.splitlines()[-6:]
    del seen, rm, fleet, engines
    gc.collect()
    torch.cuda.empty_cache()
    row["mem_after_run"] = torch.cuda.memory_allocated()
    row["threads_after_run"] = threads
    return row


def _watch_kill(torch, fleet, seen: dict):
    """Record the card's allocated bytes when the CLI kills a member and
    once the fleet has processed the loss (a reading, not a gate)."""
    kill, lose = fleet.kill_engine, fleet._kill_member

    def kill_engine(idx):
        seen["mem_before_kill"] = torch.cuda.memory_allocated()
        return kill(idx)

    def kill_member(*a, **kw):
        out = lose(*a, **kw)
        seen["mem_after_kill"] = torch.cuda.memory_allocated()
        return out

    fleet.kill_engine, fleet._kill_member = kill_engine, kill_member


def _serve_checks(torch, cfg) -> dict:
    """The outcomes the CLI runs promise beyond completing every turn."""
    import json as _json
    from repro_torch.obs import validate_chrome
    d = SERVE_DIR
    runs = {}
    for name, argv in SERVE_RUNS.items():
        runs[name] = _cli_run(torch, cfg, name,
                              [a.replace("{d}", str(d)) for a in argv])
    problems = validate_chrome(_json.loads((d / "a/trace.json").read_text()))
    if problems:
        raise AssertionError(f"serve a_paged: trace invalid: {problems[:5]}")
    if not _json.loads((d / "a/metrics.json").read_text()):
        raise AssertionError("serve a_paged: empty metrics dump")
    if not any(p.suffix == ".npz" for p in (d / "a/journal").iterdir()):
        raise AssertionError("serve a_paged: nothing journaled")
    b, c = runs["b_fleet_kill"], runs["c_fleet_drain"]
    if b["fleet"]["engines_lost"] != 1 or " lost 1 " not in b["fleet_line"]:
        raise AssertionError(f"serve b_fleet_kill: {b['fleet_line']}")
    if c["fleet"]["engines_drained"] != 1 or c["lost_turns_resubmitted"] \
            or " drained 1 " not in c["fleet_line"]:
        raise AssertionError(f"serve c_fleet_drain: {c['fleet_line']}")
    return runs


def _serve_subprocess(cfg) -> dict:
    """The entry point as users start it, over the tensor-parallel
    megastep at tp 1."""
    import os
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            cfg.name, "--paged", "--mesh", "tp=1", "--agents", "3",
            "--turns", "6"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    served = re.findall(r"^\[serve\] agent-\d+ -> tok:", out.stdout, re.M)
    if out.returncode != 0 or len(served) != 6 or "tp=1," not in out.stdout:
        raise AssertionError(f"python -m repro_torch.launch.serve: exit "
                             f"{out.returncode}, {len(served)} of 6 turns\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return {"argv": argv[1:], "returncode": 0, "turns": 6, "wall_s": wall,
            "summary": [ln for ln in out.stdout.splitlines()
                        if ln.startswith(("[serve] ttft",
                                          "[serve] megastep"))]}


def _drive_turns(be, agents: dict, max_steps: int = 400) -> tuple:
    """One turn per agent straight on a backend, stepped until each ends:
    ({agent: text}, {agent: typed error})."""
    rids = {be.begin_turn(a, "", p): a for a, p in agents.items()}
    outs, errs = {}, {}
    for _ in range(max_steps):
        if not rids:
            break
        rep = be.step()
        for rid, err in rep.failed:
            if rid in rids:
                errs[rids.pop(rid)] = err
        for rid in rep.finished:
            if rid in rids:
                outs[rids.pop(rid)] = be.collect(rid)
    if rids:
        raise AssertionError(f"turns never finished: {rids}")
    return outs, errs


def _bitexact_checks(torch, cfg32, params) -> dict:
    """The library's recovery paths at float32, full width, each against a
    run on one engine without faults on the same schedule:
    ``test_chaos.py``'s crash restore and poisoned row, ``test_fleet.py``'s
    fluid migration and disk-tier hibernate/wake."""
    import shutil
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.distributed.elastic import FleetBackend
    from repro_torch.faults import ChaosBackend, FaultPlan, FaultSpec
    from repro_torch.serving import (DiskTierKVSwapStore, PagedEngineBackend,
                                     PagedInferenceEngine, PoisonedRowError,
                                     SessionJournal)
    engines = []

    def mk(**kw):
        kw = {**dict(num_blocks=40, block_size=8, max_batch=4, max_len=96,
                     device="cuda"), **kw}
        eng = PagedInferenceEngine(cfg32, params, **kw)
        engines.append(eng)
        return eng

    def released(eng) -> int:
        for rid in list(eng.reqs):
            eng.release(rid)
        return int(eng.cache.allocator.num_used)

    d = SERVE_DIR / "bitexact"
    shutil.rmtree(d, ignore_errors=True)
    reset_counts()
    out = {}

    # a crash mid-decode, restored from the journal
    t1 = {a: f"first turn for {a}" for a in ("ca", "cb")}
    t2 = {a: f"second turn for {a}" for a in ("ca", "cb")}

    def crash_run(crash: bool):
        def factory():
            return mk(max_batch=2)
        inner = PagedEngineBackend(
            factory(), max_new_tokens=6,
            journal=SessionJournal(str(d / f"journal{int(crash)}")),
            engine_factory=factory)
        be = ChaosBackend(inner, FaultPlan()) if crash else inner
        rm = AgentRM(be, AgentRMConfig(lanes=2, detect_after_s=60.0,
                                       step_backoff_s=0.01))
        try:
            r1 = {a: rm.submit(a, p).result(300) for a, p in t1.items()}
            if crash:
                be.plan = FaultPlan([FaultSpec(be.step_idx + 5, "crash")])
            hs = {a: rm.submit(a, p) for a, p in t2.items()}
            r2 = {a: h.result(300) for a, h in hs.items()}
            rebuilds = rm.obs.metrics.counter("rm.engine_rebuilds").value
            return r1, r2, rebuilds, (be.injected["crash"] if crash else 0)
        finally:
            rm.shutdown()

    ref = crash_run(False)
    got = crash_run(True)
    if got[:2] != ref[:2] or got[2:] != (1, 1):
        raise AssertionError(f"crash restore: {got} against {ref}")
    out["crash_restore"] = {"tokens_equal": True, "rebuilds": 1}

    # a fluid migration mid-decode between two fleet members
    prompt = {"m": "stream me " * 4}
    ref, _ = _drive_turns(PagedEngineBackend(mk(), max_new_tokens=20),
                          prompt)
    fleet = FleetBackend([PagedEngineBackend(mk(name=f"engine{i}"),
                                             max_new_tokens=20)
                          for i in range(2)],
                         fluid_pages_per_tick=1, fluid_handoff_pages=1)
    ext = fleet.begin_turn("m", "", prompt["m"])
    for _ in range(4):
        fleet.step()
    if fleet.migrate("m", 1, fluid=True) != {"agent": "m", "mode": "fluid"}:
        raise AssertionError("fluid migration did not start")
    rids, got = {ext: "m"}, {}
    for _ in range(400):
        if not rids:
            break
        rep = fleet.step()
        if rep.failed:
            raise AssertionError(f"fluid migration: {rep.failed}")
        for rid in rep.finished:
            got[rids.pop(rid)] = fleet.collect(rid)
    mig = fleet.last_migration
    leaked = [released(m.backend.engine) for m in fleet.members]
    if got != ref or mig.phase != "done" or fleet._home["m"] != 1 \
            or any(leaked):
        raise AssertionError(f"fluid migration: {got} against {ref}, "
                             f"phase {mig.phase}, blocks left {leaked}")
    out["fluid_migration"] = {"tokens_equal": True,
                              "pages_sent": mig.pages_sent,
                              "blocks_left": leaked}

    # hibernate through a disk tier that spills everything, then wake
    agents = {"h1": "hibernate me " * 2, "h2": "me too " * 2}
    t2 = {a: "wake turn " + a for a in agents}
    ref_be = PagedEngineBackend(mk(), max_new_tokens=6)
    _drive_turns(ref_be, agents)
    ref, _ = _drive_turns(ref_be, t2)
    store = DiskTierKVSwapStore(str(d / "tier"), capacity_bytes=1)
    eng = mk(swap_store=store)
    be = PagedEngineBackend(eng, max_new_tokens=6)
    _drive_turns(be, agents)
    for a in agents:
        be.hibernate_session(a)
    spilled = store.tier_stats()["swap_disk_sessions"]
    got, errs = _drive_turns(be, t2)
    if errs or got != ref or spilled < 1 or released(eng):
        raise AssertionError(f"disk tier wake: {got} against {ref}, {errs}, "
                             f"{spilled} spilled")
    out["disk_tier_wake"] = {"tokens_equal": True,
                             "sessions_spilled": spilled}

    # a poisoned row fails only its own turn
    prompts = {"victim": "doomed prompt " * 2,
               "mate1": "innocent bystander one",
               "mate2": "innocent bystander two"}
    ref, _ = _drive_turns(PagedEngineBackend(mk(), max_new_tokens=8),
                          prompts)
    eng = mk()
    be = PagedEngineBackend(eng, max_new_tokens=8)
    rids = {be.begin_turn(a, "", p): a for a, p in prompts.items()}
    victim = next(r for r, a in rids.items() if a == "victim")
    got, errs = {}, {}
    for step in range(200):
        if step == 2:
            eng.inject_poison(victim)
        if not rids:
            break
        rep = be.step()
        for rid, err in rep.failed:
            errs[rids.pop(rid)] = err
        for rid in rep.finished:
            got[rids.pop(rid)] = be.collect(rid)
    if set(errs) != {"victim"} or not isinstance(errs["victim"],
                                                 PoisonedRowError) \
            or got != {a: ref[a] for a in ("mate1", "mate2")} \
            or released(eng):
        raise AssertionError(f"poisoned row: {errs}, {got} against {ref}")
    out["poisoned_row"] = {"victim_error": type(errs["victim"]).__name__,
                           "batchmates_equal": True}

    # the captured megastep (each width captured at its first call) against
    # the eager one on the same turns: tokens and pools bit for bit
    turns = {f"g{i}": f"graph or eager turn {i} " * (1 + 3 * i)
             for i in range(4)}
    runs = {}
    for graphs_on in (True, False):
        eng = mk(cuda_graphs=graphs_on)
        be = PagedEngineBackend(eng, max_new_tokens=10)
        first, _ = _drive_turns(be, turns)
        second, _ = _drive_turns(be, {a: "and again " + a for a in turns})
        torch.cuda.synchronize()
        runs[graphs_on] = (first, second,
                           [t[:, 1:].clone() for t in eng.cache.full_pools()],
                           eng.graph_stats())
    same_pools = all(torch.equal(a, b)
                     for a, b in zip(runs[True][2], runs[False][2]))
    if runs[True][:2] != runs[False][:2] or not same_pools:
        raise AssertionError("f32 graphs against eager: tokens or pools "
                             "differ")
    out["graphs_vs_eager_f32"] = {"tokens_equal": True,
                                  "pools_bitwise_equal": True,
                                  "graph": runs[True][3]}
    del runs

    torch.cuda.synchronize()
    counts = read_counts()
    dispatches = sum(e.jit_dispatches for e in engines)
    _expect("serve bitexact", counts, {"K1": cfg32.n_layers * dispatches})
    out["launches"] = counts
    out["engines"] = len(engines)
    return out


def serve_phase(torch, seed: int) -> dict:
    """The serving CLI at full gemma-2b, as users start it, then the
    library's recovery paths bit for bit at float32."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    cfg = get_config("gemma-2b")
    runs = _serve_checks(torch, cfg)
    sub = _serve_subprocess(cfg)
    cfg32 = cfg.replace(compute_dtype="float32")
    params = init_params(cfg32, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    bitexact = _bitexact_checks(torch, cfg32, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                + bitexact["launches"][k] for k in bitexact["launches"]}
    return {"runs": runs, "subprocess": sub, "bitexact": bitexact,
            "launches": launches}


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
    returns (ids (b, 1 + steps) on the host, prefill ms, decode step ms,
    prefill's last logits (b, V))."""
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
    return (np.concatenate([x.numpy() for x in ids], 1), prefill_ms,
            step_ms, last[:, -1])


def _prefill_vs_forward(path: str, last, fwd_last) -> float:
    """prefill's last logits against forward's last position, within
    PREFILL_TOL."""
    err = (last - fwd_last).abs().max().item()
    if not err <= PREFILL_TOL:
        raise AssertionError(f"{path}: prefill's last logits {err} from "
                             f"forward's, beyond {PREFILL_TOL}")
    return err


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
    ids, prefill_ms, step_ms, _ = _greedy(model, params, toks, steps)
    wall = time.perf_counter() - t0
    counts = read_counts()
    _expect("ssm", counts, {"K5": cfg.n_layers})
    ids2, prefill2_ms, step2_ms, _ = _greedy(model, params, toks, steps)
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


# ------------------------------------------------------------ families

def _decode_vs_forward(torch, path: str, model, params, toks, **inputs):
    """f32 ``forward`` over toks (b, s) against ``decode_step`` fed token
    by token from position 0, every position within 2e-3; returns the max
    abs error and the largest logit."""
    b, s = toks.shape
    ref = model.forward(params, toks, **inputs)
    state = model.init_decode_state(b, s, device="cuda")
    if "frame_embeds" in inputs:
        from repro_torch.models import encdec
        state["cross_k"], state["cross_v"] = encdec.init_cross_cache(
            params, inputs["frame_embeds"], model.cfg)
    err = 0.0
    for t in range(s):
        out = model.decode_step(params, state, toks[:, t:t + 1], t)
        err = max(err, _lockstep_err(f"{path} position {t}", out[:, 0],
                                     ref[:, t]))
    return err, ref.abs().max().item()


def _f32_cut(cfg, n_layers=None, **moe_kw):
    import dataclasses
    cfg = cfg.replace(compute_dtype="float32",
                      n_layers=n_layers or cfg.n_layers)
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def _free():
    """Collect the engines' reference cycles and hand the card's freed
    memory back, so each phase's peak is its own."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(torch, prompts, seed: int, n_layers: int = 8):
    """llama4-scout-17b-a16e at full width (d_model 5120, 40 heads of 128
    over 8 kv heads, 16 experts of 8192 and a shared one, top-1, vocab
    202048), random weights from ``seed``, bf16, its depth cut to
    ``n_layers`` of 48 (about 4.4 GB of bf16 a layer: 48 do not fit one
    card): ``main_phase`` as it runs gemma-2b, the same agents and prompts
    through AgentRM -> PagedEngineBackend -> the megastep, every layer
    routing every column of the step. Then f32 at depth 2, capacity
    factor 8 (the reference's test_decode_matches_full_forward), one row
    (a decode token alone is dropless at any factor, two are not at 16
    experts): ``forward`` over 32 tokens against ``decode_step`` token by
    token."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("llama4-scout-17b-a16e").replace(n_layers=n_layers)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = build(cfg).init_params(generator=g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    _, main = main_phase(torch, cfg, params, prompts, seed)
    del params
    _free()
    cfg32 = _f32_cut(cfg, 2, capacity_factor=8.0)
    model = build(cfg32)
    params = model.init_params(generator=g, device="cuda")
    s = 32
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                         device="cuda", dtype=torch.int32)
    reset_counts()
    err, logit_max = _decode_vs_forward(torch, "moe f32", model, params, toks)
    torch.cuda.synchronize()
    counts32 = read_counts()
    _expect("moe f32", counts32, {"K3": cfg32.n_layers,
                                  "K4": cfg32.n_layers * s})
    del params
    _free()
    return {"arch": cfg.name, "n_layers": n_layers,
            "reduced": f"n_layers 48 -> {n_layers} (memory)",
            "init_s": t_init, **main,
            "launches": {k: main["launches"][k] + counts32[k]
                         for k in counts32},
            "launches_megastep": main["launches"],
            "f32": {"reduced": "n_layers 48 -> 2", "capacity_factor": 8.0,
                    "b": 1, "s": s, "tol": LOCKSTEP_TOL,
                    "max_abs_err_decode_vs_forward_all_positions": err,
                    "logit_abs_max": logit_max, "launches": counts32}}


def mla_phase(torch, seed: int, b: int = 2, s: int = 512, steps: int = 32):
    """deepseek-v2-lite-16b at full width and depth (27 layers: a dense
    first layer of 10944, then 64 routed experts of 1408 top-6 and 2 shared;
    MLA with a 512-wide latent, 16 heads of 128 + 64 rope), random weights
    from ``seed``, bf16: ``forward`` over b x s (K3 at d 192, dv 128 in
    every layer), ``prefill`` + ``steps`` greedy ``decode_step``s (the
    absorbed decode over the latent cache: plain products, as the
    reference's are XLA), prefill's last logits held to forward's, and a
    replay with the same tokens; a profiled forward and decode step. Then
    f32 at depth 4 (the dense layer and 3 MoE layers), capacity factor 8:
    ``forward`` over 2 x 64 against ``decode_step`` token by token."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("deepseek-v2-lite-16b")
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(generator=g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits = model.forward(params, toks)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    if logits.shape != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"mla forward: shape {tuple(logits.shape)} or "
                             "non-finite logits")
    fwd_last = logits[:, -1]
    del logits
    ids, prefill_ms, step_ms, last = _greedy(model, params, toks, steps)
    counts = read_counts()
    _expect("mla", counts, {"K3": 2 * cfg.n_layers})
    prefill_vs_forward = _prefill_vs_forward("mla", last, fwd_last)
    ids2, _, _, _ = _greedy(model, params, toks, steps)
    if not np.array_equal(ids, ids2):
        raise AssertionError("mla: a replay of prefill + greedy decode gave "
                             "other tokens")
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = model.init_decode_state(b, s + 1, device="cuda")
    profile = {"forward": _profile_calls(
        torch, lambda: model.forward(params, toks), n=1),
        "decode_step": _profile_calls(
            torch, lambda: model.decode_step(params, state, toks[:, :1], s),
            n=4)}
    del params, state
    _free()
    cfg32 = _f32_cut(cfg, 4, capacity_factor=8.0)
    model32 = build(cfg32)
    params = model32.init_params(generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         device="cuda", dtype=torch.int32)
    reset_counts()
    err, logit_max = _decode_vs_forward(torch, "mla f32", model32, params,
                                        toks)
    torch.cuda.synchronize()
    counts32 = read_counts()
    _expect("mla f32", counts32, {"K3": cfg32.n_layers})
    del params
    _free()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "b": b, "s": s,
            "dtype": "bfloat16", "init_s": t_init, "forward_ms": fwd_ms,
            "prefill_ms": prefill_ms, "decode_steps": steps,
            "decode_step_median_ms": float(np.median(step_ms)),
            "greedy_ids_row0": ids[0].tolist(), "replay_deterministic": True,
            "prefill_vs_forward_last_max_abs_diff": prefill_vs_forward,
            "prefill_tol": PREFILL_TOL,
            "launches": {k: counts[k] + counts32[k] for k in counts},
            "launches_bf16": counts, "peak_mem_gb_bf16": peak,
            "profile": profile,
            "f32": {"reduced": "n_layers 27 -> 4 (the dense layer and 3 MoE "
                               "layers)", "capacity_factor": 8.0, "b": 2,
                    "s": 64, "tol": LOCKSTEP_TOL,
                    "max_abs_err_decode_vs_forward_all_positions": err,
                    "logit_abs_max": logit_max}}


def vlm_phase(torch, seed: int, b: int = 2, text: int = 64, steps: int = 16):
    """llava-next-mistral-7b at full width and depth (32 layers, d_model
    4096, 32 heads of 128 over 8 kv heads), random weights from ``seed``,
    bf16: ``forward`` with 576 patch embeddings ahead of ``text`` tokens
    (K3 at sq 640), ``prefill`` with the prefix, its last logits held to
    forward's, and ``steps`` greedy ``decode_step``s (K4); then the
    serving CLI ``--paged``, text only as the reference's paged members are
    (K1)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("llava-next-mistral-7b")
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(generator=g, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (b, text), generator=g,
                         device="cuda", dtype=torch.int32)
    patch = torch.randn((b, cfg.n_image_tokens, cfg.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
    reset_counts()
    t0 = time.perf_counter()
    logits = model.forward(params, toks, patch_embeds=patch)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    if logits.shape != (b, text, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"vlm forward: shape {tuple(logits.shape)} or "
                             "non-finite logits")
    n = cfg.n_image_tokens + text
    state = model.init_decode_state(b, n + steps, device="cuda")
    t0 = time.perf_counter()
    last = model.prefill(params, toks, state=state, patch_embeds=patch)
    tok = last[:, -1].argmax(-1).to(torch.int32)[:, None]
    ids = [tok.cpu()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        out = model.decode_step(params, state, tok, n + t)
        tok = out[:, -1].argmax(-1).to(torch.int32)[:, None]
        ids.append(tok.cpu())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not (torch.isfinite(last).all() and torch.isfinite(out).all()):
        raise AssertionError("vlm prefill / decode: non-finite logits")
    counts = read_counts()
    _expect("vlm", counts, {"K3": 2 * cfg.n_layers,
                            "K4": cfg.n_layers * steps})
    prefill_vs_forward = _prefill_vs_forward("vlm", last[:, 0],
                                             logits[:, -1])
    del params, state, logits
    _free()
    cli = _cli_run(torch, cfg, "vlm_paged", ["--paged"])
    _free()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "b": b,
            "image_tokens": cfg.n_image_tokens, "text_tokens": text,
            "dtype": "bfloat16", "init_s": t_init, "forward_ms": fwd_ms,
            "prefill_ms": prefill_ms, "decode_steps": steps,
            "decode_step_median_ms": float(np.median(step_ms)),
            "greedy_ids_row0": np.concatenate(
                [x.numpy() for x in ids], 1)[0].tolist(),
            "prefill_vs_forward_last_max_abs_diff": prefill_vs_forward,
            "prefill_tol": PREFILL_TOL,
            "launches": {k: counts[k] + cli["launches"][k] for k in counts},
            "launches_model": counts, "cli": cli}


def starcoder2_phase(torch) -> dict:
    """starcoder2-7b at full width and depth (32 layers, d_model 4608, 36
    heads of 128 over 4 kv heads, a plain GELU MLP of 18432), through the
    serving CLI ``--paged`` at its defaults (K1 at g = 9)."""
    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-7b")
    cli = _cli_run(torch, cfg, "starcoder2_paged", ["--paged"])
    _free()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, **cli}


# ------------------------------------------------------------------ tp

TP_WIDTHS = (1, 2, 4)


def _tp_mesh(tp: int):
    """A mesh of ``tp`` shards, every one on the card (cuda:0)."""
    from repro_torch.launch.mesh import make_tp_mesh
    return make_tp_mesh(tp, devices=["cuda:0"] * tp)


def _tp_serve(torch, cfg, params, prompts, tp):
    """``main``'s AgentRM run on the megastep engine, without a mesh
    (``tp`` None) or over ``tp`` shards: every turn served, one
    mixed_step_paged call and 4 x max_batch host bytes per step, K1
    launched n_layers x tp times a step. Returns (engine, tokens, row)."""
    from repro_torch.core import AgentRM, AgentRMConfig
    from repro_torch.serving import PagedEngineBackend, PagedInferenceEngine
    path = f"tp {tp}" if tp else "tp none"
    engine = PagedInferenceEngine(cfg, params, **MEGASTEP_ENGINE,
                                  mesh=_tp_mesh(tp) if tp else None)
    engine.compile_buckets()
    backend = PagedEngineBackend(engine, max_new_tokens=NEW_TOKENS,
                                 prompt_tokens=PROMPT_CAP,
                                 new_tokens_jitter=JITTER)
    rm = AgentRM(backend, AgentRMConfig(detect_after_s=120.0))
    engine.jit_dispatches = 0
    engine.steps_dispatched = 0
    g0 = engine.graph_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = _drive(rm, prompts)
    engine.sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = engine.step_stats()
    _check_turns(path, toks, _n_new)
    if st["jit_dispatches_per_step"] != 1.0 \
            or st["host_transfer_bytes_per_step"] != 4 * engine.max_batch:
        raise AssertionError(f"{path}: {st['jit_dispatches_per_step']} "
                             "calls per step, "
                             f"{st['host_transfer_bytes_per_step']} host "
                             "bytes per step")
    steps = st["steps_dispatched"]
    _expect(path, counts, {"K1": cfg.n_layers * (tp or 1) * steps})
    # one graph holds the whole step, every shard's kernels in it
    graph = _graph_window(path, engine, g0, steps)
    if graph["first_calls_in_window"]:
        raise AssertionError(f"{path}: a width was captured mid-traffic")
    n_out = sum(len(t) for t in toks.values())
    return engine, toks, {"graph": graph,
        "tp": tp, "turns": len(toks), "failed_turns": 0, "steps": steps,
        "tokens_out": n_out, "wall_s": wall, "tokens_per_s": n_out / wall,
        "step_p95_s": st["step_p95_s"],
        "jit_dispatches_per_step": st["jit_dispatches_per_step"],
        "host_transfer_bytes_per_step": st["host_transfer_bytes_per_step"],
        "k1_per_step": counts["K1"] / steps, "launches": counts}


def _live_pages(eng) -> dict:
    """{first-turn prompt: (k, v)} of every resident session: its live
    positions, (L, tokens, hkv, hd) host tensors in the pool's dtype,
    whatever blocks hold them."""
    from repro_torch.weights import numpy_to_torch
    out = {}
    for req in eng.reqs.values():
        if req.table is None:
            continue
        n = req.table.num_tokens
        out[req.prompt.tobytes()] = tuple(
            numpy_to_torch(p).flatten(1, 2)[:, :n]
            for p in eng.cache.gather(req.table))
    if len(out) != N_AGENTS:
        raise AssertionError(f"{len(out)} resident sessions, expected "
                             f"{N_AGENTS}")
    return out


def _pages_err(got: dict, want: dict) -> float:
    if got.keys() != want.keys():
        raise AssertionError("the sessions differ")
    return max((a.float() - b.float()).abs().max().item()
               for key in want for a, b in zip(got[key], want[key]))


def _first_turns(cfg, params, tokenize, prompts, mesh) -> tuple:
    """Every agent's first turn on a fresh engine, all together:
    ({agent: tokens}, the sessions' live pages)."""
    from repro_torch.serving import PagedInferenceEngine
    eng = PagedInferenceEngine(cfg, params, **MEGASTEP_ENGINE, mesh=mesh)
    rids = {a: eng.submit(tokenize(prompts[a][0]), _n_new(a), retain=True)
            for a in range(N_AGENTS)}
    eng.run_to_completion(max_steps=4096)
    return ({a: list(eng.reqs[r].out_tokens) for a, r in rids.items()},
            _live_pages(eng))


def _tp_f32(torch, cfg, prompts, seed: int) -> dict:
    """float32: (a) at the full-width 4-layer cut, tp 2 and 4 give the
    mesh-less engine's tokens on ``_replay_paged``'s schedule, and (b) a
    session hibernated at tp 2 continues at tp 4 with them, through one
    swap store; (c) at full depth, after every agent's first turn, each
    tp's live pages lie within 1e-4 of the largest |page value| of the
    mesh-less engine's (the sums' order differs), tokens reported."""
    from repro_torch.core.context.tiers import KVSwapStore
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import PagedInferenceEngine

    def tokenize(text):
        return _tokenize(cfg, text)

    def draw(c):
        return init_params(c, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")

    cut = _f32_cut(cfg, 4)
    params = draw(cut)
    # the captured step against the eager one at each tp: tokens and the
    # sessions' pages bit for bit
    want = None
    for tp in (None,) + TP_WIDTHS:
        ekw = {**MEGASTEP_ENGINE, "mesh": _tp_mesh(tp) if tp else None}
        got, _ = _graphs_vs_eager(f"tp f32 cut tp {tp}", cut, params, ekw,
                                  tokenize, prompts, True)
        want = got if want is None else want
        if got != want:
            raise AssertionError(f"tp f32 cut: tp {tp} tokens differ from "
                                 f"the mesh-less engine's, agreement "
                                 f"{_agreement(got, want)}")
    store = KVSwapStore()
    a = PagedInferenceEngine(cut, params, **MEGASTEP_ENGINE,
                             mesh=_tp_mesh(2), swap_store=store)
    rids = {ag: a.submit(tokenize(prompts[ag][0]), _n_new(ag), retain=True)
            for ag in range(N_AGENTS)}
    a.run_to_completion(max_steps=4096)
    got = {(ag, 0): list(a.reqs[r].out_tokens) for ag, r in rids.items()}
    for r in rids.values():
        a.hibernate(r)
    b = PagedInferenceEngine(cut, params, **MEGASTEP_ENGINE,
                             mesh=_tp_mesh(4), swap_store=store)
    for r in rids.values():
        b.reqs[r] = a.reqs[r]        # adopt the swapped sessions wholesale
    b._next_rid = max(rids.values()) + 1
    for ag, r in rids.items():
        b.extend(r, tokenize(prompts[ag][1]), _n_new(ag))
    b.run_to_completion(max_steps=4096)
    got.update({(ag, 1): list(b.reqs[r].out_tokens)
                for ag, r in rids.items()})
    if got != want:
        raise AssertionError("tp f32 cut: hibernated at tp 2, woken at tp "
                             "4, the tokens differ: agreement "
                             f"{_agreement(got, want)}")
    del a, b, params, store
    _free()

    full = _f32_cut(cfg)
    params = draw(full)
    want_toks, want_pages = _first_turns(full, params, tokenize, prompts,
                                         None)
    _free()
    scale = max(p.abs().max().item() for kv in want_pages.values()
                for p in kv)
    rows = {}
    for tp in TP_WIDTHS:
        toks, pages = _first_turns(full, params, tokenize, prompts,
                                   _tp_mesh(tp))
        _free()
        err = _pages_err(pages, want_pages)
        if err > 1e-4 * scale:
            raise AssertionError(f"tp f32 full depth: tp {tp} pages "
                                 f"{err} from the mesh-less engine's, "
                                 f"beyond 1e-4 x {scale}")
        rows[tp] = {"pool_max_abs_err": err,
                    "token_agreement": _agreement(toks, want_toks)}
    del params
    _free()
    return {"cut_layers": 4, "cut_tokens_equal": [1, 2, 4],
            "cut_graph_vs_eager_tokens_and_pages_equal": [None, 1, 2, 4],
            "hibernate_tp2_wake_tp4_equal": True, "full_depth": rows,
            "full_depth_pool_tol": 1e-4 * scale, "full_depth_scale": scale}


def tp_phase(torch, prompts, seed: int) -> dict:
    """The tensor-parallel megastep at starcoder2-7b's full width and depth
    (32 layers, 36 heads of 128 over 4 kv heads), every shard on the card:
    AgentRM without a mesh and at tp 1 (tokens and live pages equal bit for
    bit), tp 2 and 4 (every turn served, K1 at 32 x tp a step; token
    agreement with tp 1, no gate: bf16 sums in another order may flip a
    greedy argmax); profile windows at each tp; then ``_tp_f32``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("starcoder2-7b")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    eng, base_toks, base = _tp_serve(torch, cfg, params, prompts, None)
    base_pages = _live_pages(eng)
    del eng
    _free()
    eng, toks1, row1 = _tp_serve(torch, cfg, params, prompts, 1)
    err = _pages_err(_live_pages(eng), base_pages)
    del eng
    _free()
    if toks1 != base_toks or err != 0:
        raise AssertionError(f"tp 1: token agreement "
                             f"{_agreement(toks1, base_toks)}, pages {err} "
                             "from the mesh-less engine's, expected equal "
                             "bits")
    runs = {"none": base, "1": row1}
    for tp in (2, 4):
        eng, toks, row = _tp_serve(torch, cfg, params, prompts, tp)
        row["token_agreement_with_tp1"] = _agreement(toks, toks1)
        runs[str(tp)] = row
        del eng
        _free()
    # bf16, full depth, tp 2: the captured step's tokens equal the eager
    # one's on one schedule
    _, versus = _graphs_vs_eager(
        "tp 2 bf16", cfg, params, {**MEGASTEP_ENGINE, "mesh": _tp_mesh(2)},
        lambda text: _tokenize(cfg, text), prompts, False)
    runs["2"].update(versus)
    _free()
    # the captured step's windows, and the eager step's beside them: under
    # a replay the per-layer sums' record_function scope has no host
    # events, so only the eager windows read partial_sum_ms_per_step
    windows = {}
    for tp in TP_WIDTHS:
        windows[str(tp)] = {}
        for route, graphs_on in (("graphs", True), ("eager", False)):
            prof = profile_steps(torch, cfg, params, {
                **MEGASTEP_ENGINE, "mesh": _tp_mesh(tp),
                "cuda_graphs": graphs_on}, seed)
            for w in prof.values():
                w["k1_ms_per_launch"] = (w["paged_kernel_ms_per_step"]
                                         / (cfg.n_layers * tp))
            windows[str(tp)][route] = prof
            _free()
    del params
    _free()
    f32 = _tp_f32(torch, cfg, prompts, seed)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in base["launches"]}
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "tp1_bitwise_equal": True, "serve": runs, "profile": windows,
            "f32": f32, "launches": launches}


def encdec_phase(torch, seed: int, b: int = 2, s: int = 64,
                 steps: int = 32):
    """whisper-tiny at full size (4 encoder and 4 decoder layers, d_model
    384, 6 heads of 64, 1500 encoder positions), random weights and frame
    embeddings from ``seed``, bf16: ``forward`` over b x s text tokens
    (K3 not causal in the encoder at sq 1500, causal over the text,
    not causal across at sq = s), then ``init_cross_cache`` and ``steps``
    greedy ``decode_step``s from one token (K4 for self-attention, K3 not
    causal at sq 1 across); a profiled decode step. Then f32: ``forward``
    against ``decode_step`` token by token, within 2e-3."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build, encdec

    cfg = get_config("whisper-tiny")
    model = build(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         device="cuda", dtype=torch.int32)
    frames = torch.randn((b, cfg.enc_len, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)
    L, E = cfg.n_layers, cfg.n_enc_layers
    reset_counts()
    t0 = time.perf_counter()
    logits = model.forward(params, toks, frame_embeds=frames)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    if logits.shape != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"encdec forward: shape {tuple(logits.shape)} "
                             "or non-finite logits")
    state = model.init_decode_state(b, steps, device="cuda")
    t0 = time.perf_counter()
    state["cross_k"], state["cross_v"] = encdec.init_cross_cache(
        params, frames, cfg)
    torch.cuda.synchronize()
    cross_ms = (time.perf_counter() - t0) * 1e3
    tok, ids, step_ms = toks[:, :1], [], []
    for t in range(steps):
        t0 = time.perf_counter()
        out = model.decode_step(params, state, tok, t)
        tok = out[:, -1].argmax(-1).to(torch.int32)[:, None]
        ids.append(int(tok[0, 0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(out).all():
        raise AssertionError("encdec decode: non-finite logits")
    counts = read_counts()
    _expect("encdec", counts, {"K3": E + 2 * L + E + L * steps,
                               "K4": L * steps})
    profile = _profile_calls(
        torch, lambda: model.decode_step(params, state, tok, steps - 1), n=4)
    del params, state
    cfg32 = _f32_cut(cfg)
    model32 = build(cfg32)
    params = model32.init_params(generator=g, device="cuda")
    reset_counts()
    err, logit_max = _decode_vs_forward(
        torch, "encdec f32", model32, params, toks,
        frame_embeds=frames.float())
    torch.cuda.synchronize()
    counts32 = read_counts()
    _expect("encdec f32", counts32, {"K3": 2 * E + 2 * L + L * s,
                                     "K4": L * s})
    del params
    _free()
    return {"arch": cfg.name, "layers": [E, L], "enc_len": cfg.enc_len,
            "b": b, "s": s, "dtype": "bfloat16", "forward_ms": fwd_ms,
            "init_cross_cache_ms": cross_ms, "decode_steps": steps,
            "decode_step_median_ms": float(np.median(step_ms)),
            "greedy_ids_row0": ids,
            "launches": {k: counts[k] + counts32[k] for k in counts},
            "launches_bf16": counts, "profile_decode_step": profile,
            "f32": {"b": b, "s": s, "tol": LOCKSTEP_TOL,
                    "max_abs_err_decode_vs_forward_all_positions": err,
                    "logit_abs_max": logit_max}}


# ----------------------------------------------------------------- run

# --------------------------------------------------------------- train

TRAIN_DIR = ROOT / "build" / "train"      # the resume runs' checkpoints


def _train_cli(torch, name: str, argv: list) -> dict:
    """``repro_torch.launch.train.main(argv)`` in this process; every step's
    metrics (loss, ce, grad_norm, host seconds) with the card's peak
    allocated memory so far, and the graph stats of the train step the CLI
    built (its default route on the card: the first step the warm-up, one
    replay a step after it)."""
    from repro_torch.launch import train
    steps = []
    made = []
    make = train.make_train_step

    def recording_make(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    def on_step(m):
        steps.append({**{k: v for k, v in m.items() if k != "seconds"},
                      "ms": m["seconds"] * 1e3,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    torch.cuda.reset_peak_memory_stats()
    train.make_train_step = recording_make
    try:
        rc = train.main(argv + ["--device", "cuda", "--log-every", "1"],
                        on_step=on_step)
    finally:
        train.make_train_step = make
    for m in steps:
        if not all(math.isfinite(m[k]) for k in ("loss", "ce", "grad_norm")):
            raise AssertionError(f"train {name}: step {m['step']} not "
                                 f"finite: {m}")
    graph = made[0].graph_stats()
    if not graph["cuda_graphs"] or graph["first_calls"] != 1 \
            or graph["replays"] != len(steps) - 1:
        raise AssertionError(f"train {name}: {len(steps)} steps, graphs "
                             f"{graph}: expected one capture, then one "
                             "replay a step")
    return {"rc": rc, "steps": steps, "graph": graph}


def _train_summary(run: dict) -> dict:
    """A CLI run's exit code and per-step losses, grad norms and ms, its
    peak memory and its train step's graph stats."""
    steps = run["steps"]
    return {"rc": run["rc"], "first_step": steps[0]["step"],
            **{k: [m[k] for m in steps] for k in ("loss", "grad_norm",
                                                 "ms")},
            "peak_gb": max(m["peak_gb"] for m in steps),
            "graph": run["graph"]}


# (remat_policy, cuda_graphs), in turn: full, dots, dots, full, each on the
# eager route and on the graph route
TRAIN_ROUTES = (("full", False), ("full", True), ("dots", False),
                ("dots", True), ("dots", True), ("dots", False),
                ("full", True), ("full", False))
# the final params of "dots" against "full": max |diff| <= this x max |p|
# (the recomputed products are the kept ones bit for bit, so 0 is expected)
POLICY_PARAM_TOL = 1e-6


def _train_routes(torch, arch: str, seed: int, b: int = 8, s: int = 128,
                  steps: int = 4, routes=TRAIN_ROUTES) -> dict:
    """The train step as the CLI runs it (deterministic algorithms; params
    from ``seed``, the CLI's data stream), ``steps`` steps from fresh
    params for each (remat_policy, route) of ``routes`` in turn
    (``TRAIN_ROUTES``; the host's speed drifts within a call). Under one
    policy every run's losses, grad norms and final params (kept from its
    first run, on the host) equal bit for bit; across policies the losses
    equal bit for bit and the final params within ``POLICY_PARAM_TOL``
    (whether bit for bit is reported). On the graph route one capture,
    then one replay a step. Every run starts from a free card. Per run:
    each step's host ms (ending with its loss on the host), the capture
    seconds and graph-pool bytes, the peak reserved and allocated memory;
    then one profiled step for each (policy, route)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import make_train_step
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    model = build(cfg)
    ocfg = opt.AdamWConfig()
    data = SyntheticLM(cfg, b, s, seed=seed, device="cuda")
    kernel = "K5" if cfg.family == "ssm" else "K3"
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs, want, profiles = [], {}, {}
    try:
        for i, (policy, graphs_on) in enumerate(routes):
            _free()
            torch.cuda.reset_peak_memory_stats()
            params = model.init_train_params(seed=seed, device="cuda")
            state = opt.init(params, ocfg)
            step = make_train_step(cfg.replace(remat_policy=policy), ocfg,
                                   cuda_graphs=graphs_on)
            reset_counts()
            ms, loss, gnorm = [], [], []
            for k in range(steps):
                batch = data.batch_at(k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                loss.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                gnorm.append(float(m["grad_norm"]))
            counts = read_counts()
            _expect(f"train routes {arch} {policy}", counts,
                    {kernel: 2 * cfg.n_layers * steps})
            run = {"remat_policy": policy, "cuda_graphs": graphs_on,
                   "step_ms": ms, "loss": loss, "grad_norm": gnorm,
                   "launches": counts,
                   "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                   "peak_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9,
                   "graph": step.graph_stats()}
            if graphs_on and (run["graph"]["first_calls"] != 1
                              or run["graph"]["replays"] != steps - 1):
                raise AssertionError(f"train routes {arch}: graphs "
                                     f"{run['graph']}")
            final = leaves(params)
            if policy not in want:
                want[policy] = (loss, gnorm, [a.cpu() for a in final])
            else:
                w = want[policy]
                same = [a.dtype == x.dtype and torch.equal(a, x.to(a.device))
                        for a, x in zip(final, w[2])]
                if (loss, gnorm) != w[:2] or not all(same):
                    raise AssertionError(
                        f"train routes {arch}: run {i} ({policy}, "
                        f"cuda_graphs={graphs_on}) against the first "
                        f"{policy} run: losses {loss} / {w[0]}, grad norms "
                        f"{gnorm} / {w[1]}, {same.count(False)} param "
                        "leaves differ")
            route = f"{policy}/{'graphs' if graphs_on else 'eager'}"
            if route not in profiles and (i or len(routes) == 1):
                profiles[route] = _profile_calls(
                    torch, lambda: step(params, state, batch), n=1)
            runs.append(run)
            del params, state, step, final, m
    finally:
        torch.use_deterministic_algorithms(was)
    policies = list(want)
    across = {}
    for policy in policies[1:]:
        (l0, g0, p0), (l1, g1, p1) = want[policies[0]], want[policy]
        if l1 != l0:
            raise AssertionError(f"train routes {arch}: {policy} losses "
                                 f"{l1} against {policies[0]}'s {l0}")
        err = max(((a - x).abs().max() / max(1.0, x.abs().max())).item()
                  for a, x in zip(p1, p0))
        if not err <= POLICY_PARAM_TOL:
            raise AssertionError(f"train routes {arch}: {policy} final "
                                 f"params off {policies[0]}'s by {err}")
        across[policy] = {
            "against": policies[0], "losses_bitwise_equal": True,
            "grad_norms_bitwise_equal": g1 == g0,
            "params_max_rel_err": err, "params_tol": POLICY_PARAM_TOL,
            "params_bitwise_equal": all(torch.equal(a, x)
                                        for a, x in zip(p1, p0))}
    del want
    _free()
    median, memory = {}, {}
    for policy in policies:
        mine = [r for r in runs if r["remat_policy"] == policy]
        median[policy] = {
            route: statistics.median(ms for r in mine
                                     if r["cuda_graphs"] == (route
                                                             == "graphs")
                                     for ms in r["step_ms"][1:])
            for route in ("eager", "graphs")
            if any(r["cuda_graphs"] == (route == "graphs") for r in mine)}
        memory[policy] = {
            k: max(r[k] for r in mine)
            for k in ("peak_allocated_gb", "peak_reserved_gb")}
        memory[policy]["graph_pool_bytes"] = max(
            (sum(v for v in r["graph"]["pool_growth_bytes"].values()
                 if v is not None) for r in mine if r["cuda_graphs"]),
            default=None)
    return {"arch": arch, "b": b, "s": s, "steps": steps,
            "order": [f"{p}/{'graphs' if g else 'eager'}"
                      for p, g in routes],
            "bitwise_equal_within_policy": True, "across_policies": across,
            "runs": runs, "median_step_ms_after_first": median,
            "memory": memory, "profile": profiles}


def _backward_products(torch, arch: str, seed: int, b: int = 8,
                       s: int = 128) -> dict:
    """At full width and depth, one ``value_and_grad`` of the loss with
    remat off, "full" and "dots": the plain products (``aten.mm`` /
    ``aten.addmm``) its backward runs, counted by a dispatch mode around
    the backward alone. "dots" must run as many as remat off (no product
    twice), "full" more; the losses bit for bit equal."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticLM
    from repro_torch.tree import flatten, unflatten
    products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in products
            return func(*args, **(kwargs or {}))

    cfg = get_config(arch)
    params = build(cfg).init_train_params(seed=seed, device="cuda")
    batch = SyntheticLM(cfg, b, s, seed=seed, device="cuda").batch_at(0)
    out = {}
    for name, c in (("off", cfg.replace(remat=False)), ("full", cfg),
                    ("dots", cfg.replace(remat_policy="dots"))):
        flat, spec = flatten(params)
        live = [x.detach().requires_grad_() for x in flat]
        loss, _ = build(c).loss(unflatten(spec, live), batch)
        with Count() as count:
            torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
        out[name] = {"backward_products": count.n, "loss": loss.item()}
        del loss, live
    del params
    _free()
    n = {k: v["backward_products"] for k, v in out.items()}
    if not n["dots"] == n["off"] < n["full"] \
            or len({v["loss"] for v in out.values()}) != 1:
        raise AssertionError(f"train products {arch}: {out}")
    return {"arch": arch, "b": b, "s": s, **out}


def _train_breakdown(torch, arch: str, seed: int, b: int = 8,
                     s: int = 128, reps: int = 3) -> dict:
    """Where an eager train step's time goes, at full width and depth
    (deterministic algorithms, as the CLI runs): host ms (median of ``reps``, each
    ending in a synchronize) of the loss's forward alone (its graph
    built), of forward + backward (``value_and_grad``) and of the whole
    step (+ clip and AdamW); the backward's share of the step; then one
    step under torch.profiler: device busy, idle share, K3/K5 device ms,
    the top kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import (make_train_step,
                                                 value_and_grad)
    from repro_torch.tree import flatten, unflatten
    cfg = get_config(arch)
    model = build(cfg)
    params = model.init_train_params(seed=seed, device="cuda")
    state = opt.init(params, opt.AdamWConfig())
    batch = SyntheticLM(cfg, b, s, seed=seed, device="cuda").batch_at(0)
    step = make_train_step(cfg, cuda_graphs=False)
    grad_fn = value_and_grad(model.loss)

    def forward():
        flat, spec = flatten(params)
        live = [p.detach().requires_grad_() for p in flat]
        return model.loss(unflatten(spec, live), batch)[0]

    def timed(fn) -> float:
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
            del out
        return statistics.median(ts)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step(params, state, batch)                  # warm
        fwd = timed(forward)
        fwd_bwd = timed(lambda: grad_fn(params, batch))
        full = timed(lambda: step(params, state, batch))
        profile = _profile_calls(torch, lambda: step(params, state, batch),
                                 n=1)
    finally:
        torch.use_deterministic_algorithms(was)
    del params, state
    return {"arch": arch, "b": b, "s": s, "forward_ms": fwd,
            "forward_backward_ms": fwd_bwd, "step_ms": full,
            "backward_ms": fwd_bwd - fwd, "optimizer_ms": full - fwd_bwd,
            "backward_share": (fwd_bwd - fwd) / full, "profile": profile}


def _grads_reach(torch, arch: str, leaf: tuple, seed: int) -> dict:
    """At full width, depth cut to 2, bf16: one ``value_and_grad`` of the
    loss on the card. The attention (K3) or SSD (K5) output must carry its
    gradient function, and every layer's slice of ``leaf`` (wq/wk/wv, the
    Mamba block's in_proj: what sits before the kernel) a finite,
    non-zero gradient."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import backward as fa_bwd
    from repro_torch.kernels.ssd import backward as ssd_bwd
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    cfg = get_config(arch).replace(n_layers=2)
    model = build(cfg)
    params = model.init_train_params(seed=seed, device="cuda")
    batch = SyntheticLM(cfg, 2, 128, seed=seed, device="cuda").batch_at(0)
    reset_counts()
    calls = (fa_bwd.flash_attention_backward.calls,
             ssd_bwd.ssd_backward.calls)
    _, grads = value_and_grad(model.loss)(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    calls = (fa_bwd.flash_attention_backward.calls - calls[0],
             ssd_bwd.ssd_backward.calls - calls[1])
    kernel = "K5" if cfg.family == "ssm" else "K3"
    # each layer's kernel runs in the forward and again in the remat
    _expect(f"train grads {arch}", counts, {kernel: 2 * cfg.n_layers})
    if calls != ((0, cfg.n_layers) if kernel == "K5"
                 else (cfg.n_layers, 0)):
        raise AssertionError(f"train grads {arch}: backward calls {calls}")
    norms = {}
    for path in leaf:
        g = grads["layers"]
        for key in path:
            g = g[key]
        per_layer = [torch.linalg.vector_norm(x.float()).item() for x in g]
        if not all(math.isfinite(x) and x > 0 for x in per_layer):
            raise AssertionError(f"train grads {arch}: {'/'.join(path)} "
                                 f"per layer {per_layer}")
        norms["/".join(path)] = per_layer
    return {"arch": arch, "reduced": "n_layers -> 2", "b": 2, "s": 128,
            "launches": counts, "backward_calls": list(calls),
            "grad_norm_per_layer": norms}


def _ckpt_leaves(path: Path) -> dict:
    import numpy as np
    with np.load(path / "proc0.npz") as data:
        return {k: data[k] for k in data.files}


def train_phase(torch, seed: int) -> dict:
    """The training path on the card (``repro_torch.launch.train``, in
    this process; its step one CUDA graph, replayed from the second step
    on). gemma-2b at full width and depth (18 layers, 2.51 B params; bf16
    compute, f32 master params and AdamW moments, remat on): 4 steps of
    batch 8 x 128, no checkpoint (one would be ~30 GB); every loss and
    grad norm finite, step 0's ce under log(V) + 2, K3 launched 2 x 18 x
    4 times (forward and remat recompute). Then the same 4 steps driven
    directly under remat_policy "full" and "dots" in turn, each on the
    eager and the graph route (``_train_routes``, ``TRAIN_ROUTES``): equal
    bit for bit within a policy and to the CLI's losses, the losses of
    "dots" those of "full" bit for bit, K3 2 x 18 a step under both;
    then the backward's plain products under remat off, "full" and
    "dots" (``_backward_products``: "dots" runs as many as off), and an
    eager step's breakdown. mamba2-370m at full width and depth (48
    layers), on the graph route: 6 steps straight, then ``--fail-at 2
    --save-every 3`` (exit 42) and ``--resume`` to 6 (captured anew over
    the restored trees): the final checkpoints equal bit for bit, K5
    launched 2 x 48 a step; then 4 steps under "dots" on the graph route,
    K5 2 x 48 a step, the losses the straight run's bit for bit. Then at
    full width, depth 2, the gradients reach what sits before each
    kernel."""
    import shutil
    from repro_torch.configs import get_config

    out = {}
    cfg = get_config("gemma-2b")
    argv = ["--arch", "gemma-2b", "--steps", "4", "--batch", "8", "--seq",
            "128", "--seed", str(seed)]
    reset_counts()
    run = _train_cli(torch, "gemma-2b", argv)
    counts = read_counts()
    if run["rc"] != 0:
        raise AssertionError(f"train gemma-2b: exit {run['rc']}")
    _expect("train gemma-2b", counts, {"K3": 2 * cfg.n_layers * 4})
    ce0 = run["steps"][0]["ce"]
    if not ce0 < math.log(cfg.vocab_size) + 2.0:
        raise AssertionError(f"train gemma-2b: step 0 ce {ce0} not under "
                             f"log(V) + 2")
    emit({"phase": "train_run", "arch": "gemma-2b", "launches": counts,
          **run})
    out["gemma-2b"] = {"argv": argv, "n_layers": cfg.n_layers,
                       "remat": cfg.remat, "launches": counts,
                       "log_v_plus_2": math.log(cfg.vocab_size) + 2.0,
                       **_train_summary(run)}
    _free()
    routes = _train_routes(torch, "gemma-2b", seed)
    cli_loss = [m["loss"] for m in run["steps"]]
    if routes["runs"][0]["loss"] != cli_loss:
        raise AssertionError(f"train gemma-2b: the CLI's losses {cli_loss} "
                             f"against the direct step's "
                             f"{routes['runs'][0]['loss']}")
    emit({"phase": "train_routes", **routes})
    out["gemma-2b"]["routes"] = routes
    out["gemma-2b"]["products"] = _backward_products(torch, "gemma-2b",
                                                     seed)
    emit({"phase": "train_products", **out["gemma-2b"]["products"]})
    out["gemma-2b"]["breakdown"] = _train_breakdown(torch, "gemma-2b", seed)
    emit({"phase": "train_breakdown", **out["gemma-2b"]["breakdown"]})
    _free()

    cfg = get_config("mamba2-370m")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    base = ["--arch", "mamba2-370m", "--batch", "8", "--seq", "128",
            "--seed", str(seed), "--steps", "6"]
    per_step = 2 * cfg.n_layers
    runs = {}
    for name, extra, rc, n_steps in (
            ("straight", ["--ckpt-dir", str(TRAIN_DIR / "straight"),
                          "--save-every", "100"], 0, 6),
            ("fail", ["--ckpt-dir", str(TRAIN_DIR / "resumed"),
                      "--save-every", "3", "--fail-at", "2"], 42, 3),
            ("resume", ["--ckpt-dir", str(TRAIN_DIR / "resumed"),
                        "--save-every", "3", "--resume"], 0, 3)):
        reset_counts()
        run = _train_cli(torch, f"mamba2-370m {name}", base + extra)
        counts = read_counts()
        if run["rc"] != rc:
            raise AssertionError(f"train mamba2-370m {name}: exit "
                                 f"{run['rc']}, expected {rc}")
        if len(run["steps"]) != n_steps:
            raise AssertionError(f"train mamba2-370m {name}: "
                                 f"{len(run['steps'])} steps")
        _expect(f"train mamba2-370m {name}", counts,
                {"K5": per_step * n_steps})
        emit({"phase": "train_run", "arch": "mamba2-370m", "run": name,
              "launches": counts, **run})
        runs[name] = {"launches": counts, **_train_summary(run)}
        _free()
    final = "step_00000006"
    a = _ckpt_leaves(TRAIN_DIR / "straight" / final)
    b = _ckpt_leaves(TRAIN_DIR / "resumed" / final)
    ckpt_bytes = sum(x.nbytes for x in a.values())
    if a.keys() != b.keys() or not all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and a[k].tobytes() == b[k].tobytes() for k in a):
        raise AssertionError("train mamba2-370m: the resumed run's final "
                             "checkpoint differs from the straight run's")
    del a, b
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    # the same steps under "dots" on the graph route: K5 2 x 48 a step,
    # the losses the straight run's bit for bit
    dots = _train_routes(torch, "mamba2-370m", seed, steps=4,
                         routes=(("dots", True),))
    straight = runs["straight"]["loss"][:4]
    if dots["runs"][0]["loss"] != straight:
        raise AssertionError(f"train mamba2-370m: dots losses "
                             f"{dots['runs'][0]['loss']} against the "
                             f"straight run's {straight}")
    emit({"phase": "train_routes", **dots})
    out["mamba2-370m"] = {"n_layers": cfg.n_layers, "remat": cfg.remat,
                          "runs": runs, "resume_bitwise_equal": True,
                          "checkpoint_bytes": ckpt_bytes,
                          "dots": {"losses_bitwise_equal_full": True,
                                   **dots}}
    _free()
    out["grads_reach"] = [
        _grads_reach(torch, "gemma-2b", (("attn", "wq"), ("attn", "wk"),
                                         ("attn", "wv")), seed),
        _grads_reach(torch, "mamba2-370m", (("mamba", "in_proj"),), seed)]
    _free()
    launches = {}
    for c in ([out["gemma-2b"]["launches"]]
              + [r["launches"] for r in runs.values()]):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    # the launches of the CLI runs; the depth-2 gradient checks are not
    # the path
    return {"launches": launches, **out}


# -------------------------------------------------------------- dry-run

DRYRUN_DIR = ROOT / "build" / "dryrun"      # the cells, the checkpoint
ALLOC_GRANULE = 512         # the caching allocator rounds each block up
# gemma-2b's cells against the card, cut to its memory: decode_32k's global
# batch from 128, prefill_32k to one row of this length
DRYRUN_DECODE_BATCH = 32
DRYRUN_PREFILL_LEN = 8192
DRYRUN_REDUCED = {
    "decode_32k": {"global_batch": [128, DRYRUN_DECODE_BATCH]},
    "prefill_32k": {"global_batch": [32, 1],
                    "seq_len": [32768, DRYRUN_PREFILL_LEN]}}


def _alloc(sizes) -> int:
    """What the caching allocator holds for tensors of these byte sizes:
    each rounded up to ``ALLOC_GRANULE``."""
    return sum(-(-n // ALLOC_GRANULE) * ALLOC_GRANULE for n in sizes)


def _allocated(torch, fn):
    """(fn's result, the card's allocated bytes it left behind)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def _sweep(torch) -> dict:
    """(a) every ``iter_cells`` cell on both production meshes, on meta:
    each cell's JSON under build/dryrun/cells/, a failed cell fails the
    phase."""
    from repro_torch.configs import iter_cells
    from repro_torch.launch import dryrun
    out_dir = DRYRUN_DIR / "cells"
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {"ok": 0, "failed": 0, "skipped": 0}
    failed, skipped, cells = [], {}, {}
    for arch, shape, ok, why in iter_cells():
        for multi in (False, True):
            tag = f"{arch}__{shape.name}__{'multi' if multi else 'single'}"
            if not ok:
                counts["skipped"] += 1
                skipped[tag] = why
                continue
            try:
                cell = dryrun.run_cell(arch, shape.name, multi)
            except Exception as e:  # noqa: BLE001 — report, then fail
                counts["failed"] += 1
                failed.append(f"{tag}: {type(e).__name__}: {e}")
                continue
            counts["ok"] += 1
            (out_dir / f"{tag}.json").write_text(json.dumps(cell, indent=1))
            cells[tag] = {"flops_per_device": cell["hlo_flops_per_device"],
                          "args_bytes_per_device":
                              cell["memory"]["argument_size_in_bytes"],
                          "kernel_calls": cell["kernel_calls"],
                          "trace_s": cell["trace_s"]}
    emit({"phase": "dryrun_sweep", **counts, "failed_cells": failed,
          "skip_reasons": sorted(set(skipped.values())), "cells": cells})
    if failed:
        raise AssertionError(f"dryrun: {len(failed)} cells failed: "
                             f"{failed[:3]}")
    return {**counts, "skipped_cells": sorted(skipped)}


def _bytes_on_card(torch, cfg, seed: int, batch: int, seq: int):
    """(b) gemma-2b on the 1 x 1 local mesh of the card: the sizing's
    per-device bytes of the f32 master params, the AdamW state and the
    bf16 decode state of ``batch`` x ``seq`` against what the card
    allocates for each (each leaf rounded up to the allocator's granule).
    Returns the row."""
    from repro_torch.distributed.sharding import (decode_state_shardings,
                                                  opt_state_shardings,
                                                  param_shardings)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    mesh = make_local_mesh("cuda")
    model = build(cfg)
    p_abs = dryrun.abstract_params(cfg)
    o_abs = opt.init(p_abs, opt.AdamWConfig())
    s_abs = dryrun.abstract_decode_state(cfg, batch, seq)
    predicted = {
        "params": dryrun.leaf_bytes(p_abs, param_shardings(cfg, mesh,
                                                           p_abs)),
        "opt_state": dryrun.leaf_bytes(o_abs, opt_state_shardings(
            cfg, mesh, o_abs, p_abs)),
        "decode_state": dryrun.leaf_bytes(s_abs, decode_state_shardings(
            cfg, mesh, s_abs))}
    params, got_p = _allocated(torch, lambda: model.init_train_params(
        seed=seed, device="cuda"))
    state, got_o = _allocated(torch, lambda: opt.init(
        params, opt.AdamWConfig()))
    del params, state
    _free()
    dstate, got_s = _allocated(torch, lambda: model.init_decode_state(
        batch, seq, device="cuda"))
    del dstate
    row = {"mesh": dict(mesh.shape), "decode_batch": batch,
           "decode_seq": seq}
    for name, got in (("params", got_p), ("opt_state", got_o),
                      ("decode_state", got_s)):
        sizes = predicted[name]
        row[name] = {"predicted_bytes": sum(sizes),
                     "predicted_allocated": _alloc(sizes),
                     "allocated_delta": got}
        if got != _alloc(sizes):
            raise AssertionError(f"dryrun bytes {name}: the card allocated "
                                 f"{got}, the sizing predicts "
                                 f"{_alloc(sizes)} ({sum(sizes)} before "
                                 "the allocator's rounding)")
    return row


def _work_on_card(torch, cfg, seed: int, batch: int, seq: int,
                  prefill_len: int) -> dict:
    """(c) the same step on the card and on meta under ``analyze_step``:
    gemma-2b's decode step at the cut decode_32k (K4) and a prefill of 1 x
    ``prefill_len`` (K3, float32 logits over the vocabulary); the work
    counts (aten operations plus the kernels') and the bytes materialized
    (the kernels' workspaces included) must be equal, and the card's
    kernel launches equal the meta step's kernel calls."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import build
    from repro_torch.training.train_step import make_serve_steps
    prefill_step, decode_step = make_serve_steps(cfg)
    model = build(cfg)
    dstate = model.init_decode_state(batch, seq, device="cuda")
    params = model.init_params(generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    meta_params = model.init_params(device="meta")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                          device="cuda", dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (1, prefill_len), generator=g,
                         device="cuda", dtype=torch.int32)
    steps = [
        ("decode", decode_step, [params, dstate, token, seq - 1],
         (meta_params, dryrun.abstract_decode_state(cfg, batch, seq),
          token.to("meta"), seq - 1), "K4"),
        ("prefill", prefill_step, [params, {"tokens": toks}],
         (meta_params, {"tokens": toks.to("meta")}), "K3")]
    del dstate
    row = {}
    while steps:
        name, fn, card_args, meta_args, kernel = steps.pop(0)
        reset_counts()
        t0 = time.perf_counter()
        out, card = analyze_step(fn, *card_args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = read_counts()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"dryrun work {name}: non-finite logits")
        del out
        _, meta = analyze_step(fn, *meta_args)
        keys = ("dot_flops", "aten_flops", "kernel_flops", "kernel_calls",
                "bytes_materialized")
        same = {k: card[k] == meta[k] for k in keys}
        row[name] = {"card": card, "meta": meta, "launches": launches,
                     "equal": same, "card_s": card_s}
        if not all(same.values()):
            raise AssertionError(f"dryrun work {name}: card {card} vs "
                                 f"meta {meta}")
        _expect(f"dryrun work {name}", launches,
                {kernel: cfg.n_layers})
        if launches[kernel] != card["kernel_calls"][kernel]:
            raise AssertionError(f"dryrun work {name}: {launches} launches "
                                 f"vs {card['kernel_calls']} counted")
        emit({"phase": "dryrun_work", "step": name, **row[name]})
        del card_args          # the decode state, before the prefill's logits
        _free()
    del params
    return row


def _restore_on_card(torch, cfg, seed: int) -> dict:
    """(d) a gemma-2b f32 checkpoint written by the port, restored onto a
    2 x 2 ("data", "model") mesh whose four positions are the one card:
    joined, it equals the saved bits; each slice's shape follows
    ``param_pspec``; the allocated bytes equal the sizing's distinct
    (device, slice) pieces."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build
    from repro_torch.tree import leaves
    ck_dir = DRYRUN_DIR / "ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    mesh = Mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    params = build(cfg).init_train_params(seed=seed, device="cuda")
    t0 = time.perf_counter()
    ck = Checkpointer(str(ck_dir))
    ck.save(1, params)
    save_s = time.perf_counter() - t0
    like = dryrun.abstract_params(cfg)
    t0 = time.perf_counter()
    (placed, step, _), got = _allocated(torch, lambda: sharding.
                                        elastic_restore(cfg, ck, like, mesh))
    restore_s = time.perf_counter() - t0
    pieces = dryrun.placed_pieces(cfg, like, mesh)
    want = _alloc(n for _, n in pieces)
    if step != 1 or got != want:
        raise AssertionError(f"dryrun restore: step {step}, the card "
                             f"allocated {got}, the sizing predicts {want}")
    for (coords, _), tree in zip(mesh.positions(), placed):
        def shape_ok(name, piece):
            full = like
            for part in name.split("/"):
                full = full[part]
            spec = sharding.param_pspec(cfg, mesh, name, full)
            sl = sharding.spec_slices(mesh, coords, full.shape, spec)
            if tuple(piece.shape) != tuple(hi - lo for lo, hi in sl):
                raise AssertionError(f"dryrun restore {coords} {name}: "
                                     f"{tuple(piece.shape)} under {spec}")
        sharding._map_with_path(shape_ok, tree)
    joined = sharding.join(placed)
    equal = all(torch.equal(a, b) for a, b in zip(leaves(joined),
                                                  leaves(params)))
    if not equal:
        raise AssertionError("dryrun restore: the joined tree differs from "
                             "the saved params")
    n_leaves = len(leaves(params))
    del params, placed, joined
    shutil.rmtree(ck_dir, ignore_errors=True)
    _free()
    return {"mesh": dict(mesh.shape), "positions": mesh.size,
            "leaves": n_leaves, "pieces": len(pieces),
            "predicted_bytes": sum(n for _, n in pieces),
            "predicted_allocated": want, "allocated_delta": got,
            "joined_bitwise_equal": True, "save_s": save_s,
            "restore_s": restore_s}


def _pool_roundtrip(torch, seed: int, plen: int = 1000) -> dict:
    """(e) ``write_prefill`` / ``gather`` / ``scatter`` / ``set_pools`` on
    starcoder2-7b pools at full width (32 layers, 4 kv heads of 128, bf16,
    pages of 16), at tp 1 and tp 2 (both shards on the card): the pages
    hold the prefill's bf16 bits, the padded tail is zero, the scattered
    copy equal, tp 1 and tp 2 the same bytes."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.serving.paging.pool import PagedKVCache
    from repro_torch.weights import torch_to_numpy
    cfg = get_config("starcoder2-7b")
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(seed)
    k_pre = rng.standard_normal((L, plen, hkv, hd)).astype(np.float32)
    v_pre = rng.standard_normal((L, plen, hkv, hd)).astype(np.float32)
    want_k = torch_to_numpy(torch.from_numpy(k_pre).to(torch.bfloat16))
    gathered, row = {}, {"plen": plen, "pool_shape": None}
    for tp in (1, 2):
        cache = PagedKVCache(cfg, num_blocks=2 * (-(-plen // 16)) + 1,
                             block_size=16, mesh=make_tp_mesh(
                                 tp, devices=["cuda:0"] * tp))
        row["pool_shape"] = list(cache.full_pools()[0].shape)
        pt = cache.alloc_table(plen)
        cache.write_prefill(pt, k_pre, v_pre)
        kg, vg = cache.gather(pt)
        flat = kg.reshape(L, -1, hkv, hd)
        if not (np.array_equal(flat[:, :plen], want_k)
                and (flat[:, plen:] == 0).all()):
            raise AssertionError(f"dryrun pool tp={tp}: the pages are not "
                                 "the prefill's bits and a zero tail")
        pt2 = cache.scatter(kg, vg, plen)
        cache.set_pools([{n: t.clone() for n, t in s.items()}
                         for s in cache.pools()])
        kg2, vg2 = cache.gather(pt2)
        if not (np.array_equal(kg, kg2) and np.array_equal(vg, vg2)):
            raise AssertionError(f"dryrun pool tp={tp}: scatter + "
                                 "set_pools changed the pages")
        gathered[tp] = (kg, vg)
        del cache
    if not all(np.array_equal(a, b) for a, b in zip(gathered[1],
                                                    gathered[2])):
        raise AssertionError("dryrun pool: tp 1 and tp 2 differ")
    return {**row, "bitwise": True, "tp": [1, 2],
            "page_bytes": int(gathered[1][0].nbytes)}


def dryrun_memory(torch, seed: int) -> dict:
    """(b) and (d), the checks of allocated bytes. ``python3 chip_smoke.py
    --dryrun-memory`` runs them in a process of their own: the caching
    allocator hands out a cached block less than 1 MB larger than a
    request whole, and ``memory_allocated`` counts the whole block, so
    the free blocks earlier phases leave would add to the deltas."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    cfg = get_config("gemma-2b")
    seq = SHAPES_BY_NAME["decode_32k"].seq_len
    out = {"bytes": _bytes_on_card(torch, cfg, seed, DRYRUN_DECODE_BATCH,
                                   seq)}
    emit({"phase": "dryrun_bytes", **out["bytes"]})
    _free()
    out["restore"] = _restore_on_card(torch, cfg, seed)
    emit({"phase": "dryrun_restore", **out["restore"]})
    return out


def _dryrun_memory_subprocess(seed: int) -> dict:
    """``dryrun_memory`` in a fresh process; its JSON lines are passed
    through and its result returned."""
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-memory",
            "--seed", str(seed)]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if out.returncode != 0 or not lines:
        raise AssertionError(f"chip_smoke.py --dryrun-memory: exit "
                             f"{out.returncode}\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def dryrun_phase(torch, seed: int) -> dict:
    """The dry-run on meta and against the card: (a) the sweep, (b) the
    sizing's bytes against the card's allocations, (c) the work of the
    same decode (K4) and prefill (K3) steps on the card and on meta, (d) a
    checkpoint restored onto a 2 x 2 mesh of the card, (e) the pool's
    prefill write and round trip at tp 1 and 2. decode_32k's global batch
    and prefill_32k are cut as ``DRYRUN_REDUCED`` says (the card's
    memory)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    cfg = get_config("gemma-2b")
    out = {"reduced": DRYRUN_REDUCED}
    seq = SHAPES_BY_NAME["decode_32k"].seq_len
    t0 = time.perf_counter()
    out["sweep"] = _sweep(torch)
    out["sweep"]["seconds"] = time.perf_counter() - t0
    out.update(_dryrun_memory_subprocess(seed))
    out["work"] = _work_on_card(torch, cfg, seed, DRYRUN_DECODE_BATCH, seq,
                                DRYRUN_PREFILL_LEN)
    out["pool"] = _pool_roundtrip(torch, seed)
    launches = {}
    for step in out["work"].values():
        for k, v in step["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["work"] = {k: {"launches": v["launches"], "equal": v["equal"],
                       "dot_flops": v["card"]["dot_flops"],
                       "kernel_flops": v["card"]["kernel_flops"]}
                   for k, v in out["work"].items()}
    return {"launches": launches, **out}


def _template_args(rest: str) -> list:
    """The template arguments a mangled name's ``I...E`` list starts with:
    float, bf16, fp8 (e4m3) or an int / bool literal; a substitution
    (``S_``) repeats the type before it, as the kernels' repeated ones do."""
    names = {"__nv_bfloat16": "bf16", "__nv_fp8_e4m3": "fp8"}
    out, i = [], 1
    while i < len(rest) and rest[i] != "E":
        lit = re.match(r"L[a-z](\d+)E", rest[i:])
        sub = re.match(r"S\d*_", rest[i:])
        ident = re.match(r"(\d+)", rest[i:])
        if rest[i] == "f":
            out.append("float")
            i += 1
        elif lit:
            out.append(lit.group(1))
            i += lit.end()
        elif sub:
            out.append(out[-1] if out else "?")
            i += sub.end()
        elif ident:
            n = int(ident.group(1))
            name = rest[i + ident.end():i + ident.end() + n]
            out.append(names.get(name, name))
            i += ident.end() + n
        else:
            break
    return out


def _kernel_name(mangled: str) -> str:
    """name<template args> of a mangled kernel: the length-prefixed
    identifier ending in _kernel (a namespace hash may hold digits just
    before its length), then its type and int arguments."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            size = int(m.group()[i:])
            ident = mangled[m.end():m.end() + size]
            if len(ident) == size and ident.endswith("_kernel"):
                rest = mangled[m.end() + size:]
                if not rest.startswith("I"):
                    return ident
                return f"{ident}<{','.join(_template_args(rest))}>"
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
    # the dryrun phase's allocation checks, which it runs in a fresh
    # process of their own (see dryrun_memory)
    ap.add_argument("--dryrun-memory", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    # the train phase's bitwise resume runs deterministic cuBLAS, whose
    # workspace is fixed when the first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if args.dryrun_memory:
        emit(dryrun_memory(torch, args.seed))
        return 0
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
    grads = {"K3": k3_grad_cases(torch, flush),
             "K5": ssd_grad_cases(torch, flush)}
    fp8_rows = kv_fp8_cases(torch, flush)
    fp8 = {k: [r for r in fp8_rows if r["kernel"] == k]
           for k in ("K1", "K2", "K4")}
    fp8["K1"].sort(key=lambda r: (r["dtype"] != "bfloat16", -r["C"]))
    # K1's headline is the widest bucket of the main path, C = 256
    cases["K1"].sort(key=lambda r: (r["dtype"] != "bfloat16", -r["C"]))
    # K3's the dense engine's longest prompt, sq = 96
    cases["K3"].sort(key=lambda r: (r["dtype"] != "bfloat16",
                                    r["sq"] != 96, r["hkv"] != 1))
    emit({"phase": "kernels", "cases": sum(map(len, cases.values())),
          "gradient_cases": sum(map(len, grads.values())),
          "fp8_cases": sum(map(len, fp8.values())),
          "fp8_bitwise_upcast": True,
          "all_within_tol": True, "all_within_walk_tol": True,
          "bitwise_twin": True, "bitwise_repeat": True,
          "k2_equals_k1_at_c1": True})

    cfg = get_config("gemma-2b")     # full width, bf16 compute
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(args.seed), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompts = make_prompts(args.seed)

    t0 = time.perf_counter()

    def done(name: str, row: dict):
        """Emit a phase's line with its own seconds, counted from the end
        of the phase before."""
        nonlocal t0
        emit({"phase": name, "card": smi,
              "seconds": time.perf_counter() - t0, **row})
        t0 = time.perf_counter()

    mega_toks, main = main_phase(torch, cfg, params, prompts, args.seed)
    done("main", {"init_s": t_init, **main})
    legacy_toks, legacy = legacy_phase(torch, cfg, params, prompts,
                                       mega_toks, args.seed)
    done("legacy", legacy)
    dense_toks, dense = dense_phase(torch, cfg, params, prompts)
    done("dense", dense)
    kv8 = kv_fp8_phase(torch, cfg, params, prompts,
                       {"main": (mega_toks, main), "legacy": (legacy_toks,
                                                              legacy),
                        "dense": (dense_toks, dense)})
    done("kv_fp8", kv8)
    del params
    _free()
    serve = serve_phase(torch, args.seed)
    done("serve", serve)
    lockstep = lockstep_phase(torch, args.seed)
    done("lockstep", lockstep)
    # the engines of the serving phases hold the gemma-2b params in
    # reference cycles: collect them, so each new phase's peak is its own
    _free()
    ssm = ssm_phase(torch, args.seed)
    done("ssm", ssm)
    _free()
    hybrid = hybrid_phase(torch, args.seed)
    done("hybrid", hybrid)
    _free()
    moe = moe_phase(torch, prompts, args.seed)
    done("moe", moe)
    mla = mla_phase(torch, args.seed)
    done("mla", mla)
    vlm = vlm_phase(torch, args.seed)
    done("vlm", vlm)
    starcoder2 = starcoder2_phase(torch)
    done("starcoder2", starcoder2)
    tp = tp_phase(torch, prompts, args.seed)
    done("tp", tp)
    encdec = encdec_phase(torch, args.seed)
    done("encdec", encdec)
    _free()
    train = train_phase(torch, args.seed)
    done("train", train)
    _free()
    dry = dryrun_phase(torch, args.seed)
    done("dryrun", dry)

    launches = {name: sum(p["launches"][name]
                          for p in (main, legacy, dense, serve, lockstep,
                                    ssm, hybrid, moe, mla, vlm, starcoder2,
                                    tp, encdec, train, dry))
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
    # the gradient's headline: the training path's bf16 shape
    for entry, rows in ((kernels[2], grads["K3"]),
                        (kernels[4], grads["K5"])):
        entry.update(train_forward_ms=rows[0]["forward_ms"],
                     train_backward_ms=rows[0]["backward_ms"],
                     train_backward_bound_ms=rows[0]["bound_ms"])
    # the fp8 KV cache's variants (e4m3 K/V), their launches the kv_fp8
    # phase's; beside each, the same kernel on the upcast pools in turns
    # and SDPA on them (SDPA takes no fp8 K/V: library_ms is null)
    for k, base in (("K1", kernels[0]), ("K2", kernels[1]),
                    ("K4", kernels[3])):
        entry = kernel_entry(f"{base['name']}[kv float8_e4m3fn]", fp8[k],
                             kv8["launches"][k], base["source"],
                             base["replaces"])
        head = fp8[k][0]
        entry.update(kv_dtype="float8_e4m3fn", fp8_ab_ms=head["fp8_ms"],
                     upcast_ab_ms=head["upcast_ms"],
                     sdpa_upcast_ms=head["sdpa_upcast_ms"],
                     library_note=head["library_note"])
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
