#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (several for the kernel cases):

1. device   — the card's name and power limit (nvidia-smi); fails without
              CUDA.
2. build    — nvcc builds the port's three kernel sources into
              build/kernels/, one process each, all started together.
3. kernels  — each kernel against its plain PyTorch version on the card, in
              bf16 and f32, at the shapes its path gives it (gemma-2b heads:
              hq=8, hkv=1, d=dv=256):
              K1 paged chunked prefill: b=8, blk=16, C in {1, 8, 64, 256},
                 ragged valids, plus one hkv=2 case, and bit for bit against
                 its gathered-view twin;
              K2 paged decode: b=8, blk=16, histories up to ~900 tokens,
                 plus one hkv=2 case;
              K3 flash attention: b=1, sq in {33, 96, 256}, plus one hkv=2
                 case and one dv != d case;
              K4 decode over a contiguous cache: b=4 slots, S=1024, per-row
                 lengths from 1 up, plus one scalar-length case.
              Times the kernel, the plain version and one PyTorch library
              call (SDPA), beside the least time the card could take.
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
              turn completes, the launch counts and a deterministic replay.
7. lockstep — full-width gemma-2b in float32, b=2, s=64: ``forward`` logits
              (K3) against ``decode_step`` fed token by token at a scalar
              cache_len (K4), within 2e-3, and ``prefill`` + ``decode_step``
              against ``forward`` on the next token.

Every kernel's launch count is set to 0 just before a path is driven and
read just after; launches made to compare a kernel with its plain version
are not counted. Then the ``{"kernels": [...]}`` line, the card's
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero before that line is printed.
"""
from __future__ import annotations

import argparse
import json
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


def _check(name, got, want, dname):
    """Kernel vs plain version. bf16: both round the f32 result to bf16,
    so they may differ by one bf16 ulp of outputs below ~1.5 (1e-2).
    f32: the same math summed in another order over d=256 and the keys,
    1e-5."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dname]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: max_abs_err {err} beyond {tol}")
    return err


def measure(torch, flush, kernel: str, case: dict, dname: str, fn, plain,
            library, library_as_out, bound: dict, reps: int = 20) -> dict:
    """Check ``fn`` (the kernel) against ``plain`` on the card, then time
    it, the plain version and ``library`` (one PyTorch call computing the
    same function, never called by the port; ``library_as_out`` maps its
    result to the kernel's layout for its error). Emits and returns the
    case's row."""
    out, want = fn(), plain()
    torch.cuda.synchronize()
    err = _check(f"{kernel} {case}", out, want, dname)
    ms, host_ms = time_ms(fn, reps, flush)
    plain_ms, _ = time_ms(plain, reps, flush)
    lib_err = (library_as_out(library()).float()
               - want.float()).abs().max().item()
    lib_ms, _ = time_ms(library, reps, flush)
    row = {"kernel": kernel, **case, "dtype": dname, "max_abs_err": err,
           "tol": TOL[dname], "ms": ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_max_abs_err": lib_err, **bound}
    emit({"phase": "kernel_case", **row})
    return row


def _tile_heads(x, g):
    """(b, s, hkv, d) -> (b, hkv*g, s, d) with kv head h % hkv at head h:
    K/V laid out for SDPA under the g_major pairing."""
    return x.transpose(1, 2).repeat(1, g, 1, 1)


# ------------------------------------------------------------- kernels

def _paged_case(torch, dtype, C, hkv, seed, *, b=8, hq=8, d=256, blk=16,
                npages=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = b * npages + 1
    q = torch.randn((b, C, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((nb, blk, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((nb, blk, hkv, d), generator=g, device="cuda").to(dtype)
    ids = torch.randperm(nb - 1, generator=g, device="cuda")[: b * npages]
    pt = (ids + 1).reshape(b, npages).to(torch.int32)
    # ragged rows: inactive, decode-like, partial, full, then random
    valids = [0, 1, max(C // 3, 1), C] + [
        int(x) for x in torch.randint(0, C + 1, (b - 4,), generator=g,
                                      device="cuda")]
    cache = [0, 37, blk + 3, 5 * blk] + [
        int(x) for x in torch.randint(0, (npages - 8) * blk, (b - 4,),
                                      generator=g, device="cuda")]
    cache = [min(c, npages * blk - C) for c in cache]
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


def k1_cases(torch, flush):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref
    rows = []
    cases = [(dt, C, 1) for dt in (torch.bfloat16, torch.float32)
             for C in (1, 8, 64, 256)] + [(torch.bfloat16, 64, 2)]
    for n, (dtype, C, hkv) in enumerate(cases):
        args = _paged_case(torch, dtype, C, hkv, seed=1000 + n)
        q, k, v, lens, vals, pt = args
        dname = _dname(dtype)
        out = ops.paged_prefill_attention(*args, pairing="g_major")
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        twin = ops.paged_prefill_attention_contig(q, kg.contiguous(),
                                                  vg.contiguous(), lens,
                                                  vals, pt, pairing="g_major")
        torch.cuda.synchronize()
        if not torch.equal(out, twin):
            raise AssertionError(f"K1 C={C} {dname}: paged kernel != its "
                                 "gathered-view twin bit for bit")
        g = q.shape[2] // hkv
        mask = ref._mixed_mask(C, kg.shape[1], lens, vals)[:, None]
        qs, ks, vs = q.transpose(1, 2), _tile_heads(kg, g), _tile_heads(vg, g)
        rows.append(measure(
            torch, flush, "K1", {"C": C, "hkv": hkv, "pairing": "g_major",
                                 "bitwise_twin": True}, dname,
            lambda: ops.paged_prefill_attention(*args, pairing="g_major"),
            lambda: ref.paged_prefill_attention_ref(*args,
                                                    pairing="g_major"),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2),
            _prefill_bound(*args, dname)))
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
        rows.append(measure(
            torch, flush, "K2", {"b": b, "hkv": hkv, "pairing": "g_major",
                                 "max_len": int(lens.max())}, dname,
            lambda: ops.paged_attention(q, k, v, lens, pt,
                                        pairing="g_major"),
            lambda: ref.paged_attention_ref(q[:, 0], k, v, lens, pt,
                                            pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname)))
    return rows


def k3_cases(torch, flush):
    """K3 at the dense engine's prefill lengths (byte prompts of up to 96
    tokens, a ragged 33) and beyond, at gemma-2b heads; one hkv=2 case
    (chatglm3-6b's grouping at its head_dim) and one dv != d case (the MLA
    shapes: qk 192, v 128)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    rows = []
    cases = [(dt, sq, 8, 1, 256, 256) for dt in (torch.bfloat16, torch.float32)
             for sq in (33, 96, 256)]
    cases += [(torch.bfloat16, 96, 8, 2, 128, 128),
              (torch.bfloat16, 96, 16, 16, 192, 128)]
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
        rows.append(measure(
            torch, flush, "K3", {"b": 1, "sq": sq, "hq": hq, "hkv": hkv,
                                 "d": d, "dv": dv, "pairing": "g_major"},
            dname,
            lambda: ops.flash_attention(q, k, v, pairing="g_major"),
            lambda: ref.attention_ref(q, k, v, pairing="g_major"),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   is_causal=True),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname)))
    return rows


def k4_cases(torch, flush):
    """K4 at the dense engine's decode shape: 4 slots of a 1024-token
    cache, per-row lengths from 1 up; and one scalar length (the lockstep
    decode)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    rows = []
    cases = [(torch.bfloat16, False), (torch.float32, False),
             (torch.bfloat16, True)]
    b, S, hq, hkv, d = 4, 1024, 8, 1, 256
    for n, (dtype, scalar) in enumerate(cases):
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
        rows.append(measure(
            torch, flush, "K4", {"b": b, "S": S, "scalar_len": scalar,
                                 "lens": lens, "pairing": "g_major"}, dname,
            lambda: ops.decode_attention(q, k, v, kv_len, pairing="g_major"),
            lambda: ref.decode_attention_ref(q[:, 0], k, v, kv_len,
                                             pairing="g_major")[:, None],
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), ks, vs,
                                                   attn_mask=mask),
            lambda o: o.transpose(1, 2), _bound(nbytes, flops, dname)))
    return rows


# ------------------------------------------------------- launch counts

def wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    return {"K1": pa.paged_prefill_attention, "K2": pa.paged_attention,
            "K3": fa.flash_attention, "K4": da.decode_attention}


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
                v for k, v in dev.items() if "paged_kernel" in k),
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


# ----------------------------------------------------------------- run

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
    from repro_torch.models.transformer import init_params

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = [pa.SOURCE, fa.SOURCE, da.SOURCE]
    build.build_all(sources)
    pa.load_kernel()
    pa.load_kernel("paged_decode_attention")
    fa.load_kernel()
    da.load_kernel()
    ptxas = {s.name: [ln.strip() for ln in build.ptxas_log.get(s, "")
                      .splitlines() if "registers" in ln or "spill" in ln]
             for s in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    cases = {"K1": k1_cases(torch, flush), "K2": k2_cases(torch, flush),
             "K3": k3_cases(torch, flush), "K4": k4_cases(torch, flush)}
    # K1's headline is the widest bucket of the main path, C = 256
    cases["K1"].sort(key=lambda r: (r["dtype"] != "bfloat16", -r["C"]))
    # K3's the dense engine's longest prompt, sq = 96
    cases["K3"].sort(key=lambda r: (r["dtype"] != "bfloat16",
                                    r["sq"] != 96, r["hkv"] != 1))
    emit({"phase": "kernels", "cases": sum(map(len, cases.values())),
          "all_within_tol": True, "bitwise_twin": True})

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

    launches = {name: sum(p["launches"][name]
                          for p in (main, legacy, dense, lockstep))
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
                     ref + "decode_attention/kernel.py:59")]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
