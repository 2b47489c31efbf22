#!/usr/bin/env python3
"""A/B the port's kernels on one GPU: ``chip_smoke.py``'s kernel cases of
another tree (``--base``, e.g. the parent commit unpacked with
``git archive``) and of this one, in the order base, this, this, base, so
both are measured on one card under the same conditions.

    python3 kernel_ab.py --base DIR [--cases k1,k2]

Each run is its own process in its tree (its own ``chip_smoke.py``, sources
and build directory). Every case prints one JSON line with its tree's
label; then one line per case with both trees' median device ms. Needs a
CUDA device, as ``chip_smoke.py`` does.

    python3 kernel_ab.py --fp8

instead A/Bs, in this tree and one process, K1, K2 and K4 on e4m3 pools
(the fp8 KV cache) against the same kernels on the pools upcast to q's
dtype: ``chip_smoke.py``'s ``kv_fp8_cases``, each timed in turns
(upcast, fp8, fp8, upcast). One line per case with each turn's median
device ms and the fp8 / upcast ratio of their means.

    python3 kernel_ab.py --base DIR --split

instead A/Bs the bf16 split decode (K1 at C = 1, and K2) in one process:
the base tree's ``paged_decode_attention`` (its own source built into its
own library, launched with its plan's ``split``) against this tree's
wrapper, at the benchmark cells' decode shapes (``SPLIT_CASES``), in turns
(base, this, this, base). Both outputs are held to the plain version; one
line per case with each turn's median device ms, the byte bound and the
share of it each reaches, and beside them the plain version's and one
SDPA call's device ms.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# a case's identity across trees (its shapes, not its plan), then the plan
IDENTITY = ("kernel", "b", "C", "hkv", "sq", "S", "shape", "scalar_len",
            "dtype")
KEYS = IDENTITY + ("route", "n_split")
RUN = """
import json, sys, torch
import chip_smoke as cs
flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
for name in sys.argv[1].split(","):
    for r in getattr(cs, name + "_cases")(torch, flush):
        print("AB " + json.dumps(r), flush=True)
"""


def run(tree: Path, label: str, cases: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", RUN, cases], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({tree}) failed:\n{proc.stderr[-4000:]}")
    rows = [json.loads(ln[3:]) for ln in proc.stdout.splitlines()
            if ln.startswith("AB ")]
    for r in rows:
        print(json.dumps({"tree": label, **{k: r[k] for k in KEYS if k in r},
                          "ms": r["ms"], "library_ms": r["library_ms"]}),
              flush=True)
    return rows


# (name, b, hq, hkv, npages, lengths low, high): d = dv = 128, pages of
# 16; chatglm3-6b's decode cell (16 rows over 1-5k keys of an 8,192-key
# table) and starcoder2-7b's fleet (16 rows, 1-3k of 16,384)
SPLIT_CASES = [("glm3-longctx-decode", 16, 32, 2, 512, 1, 5000),
               ("sc2-agent-fleet", 16, 36, 4, 1024, 1, 3000)]


def _base_split_plan(da, npages, blk, b, hq, hkv, d, dv, n_sm):
    """The split of the base tree's bf16 split decode (the CUDA-core pass,
    ranges of whole pages from the shapes alone)."""
    limit = da._max_split(hq // hkv, d, dv, 2, align=blk, id_bytes=4)
    return da.split_plan(npages * blk, b, hkv, n_sm, limit, align=blk)


def split_ab(base: Path, reps: int = 20, seed: int = 0) -> None:
    """The bf16 split decode of ``base`` against this tree's, in turns, in
    this process: one JSON line per case of ``SPLIT_CASES``."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import launch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.paged_attention import ops, ref
    source = base / "src/repro_torch/kernels/paged_attention/csrc" \
        / "paged_prefill_attention.cu"
    old_fn = launch.bind(source, "paged_decode_attention", 9, 8, 1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    for name, b, hq, hkv, npages, lo, hi in SPLIT_CASES:
        d = dv = 128
        blk = 16
        q, k, v, _, _, pt = cs._paged_case(torch, torch.bfloat16, 1, hkv,
                                           seed=seed + npages, b=b, hq=hq,
                                           d=d, npages=npages,
                                           rows=([0] * b, [0] * b))
        lens = torch.randint(lo, hi + 1, (b,), generator=gen,
                             dtype=torch.int32).cuda()
        split, n_split = _base_split_plan(da, npages, blk, b, hq, hkv, d, dv,
                                          da.sm_count(q.device))
        out_old = torch.empty_like(q)
        ws = torch.empty(b * hq * n_split * (dv + 2), dtype=torch.float32,
                         device="cuda")

        def old():
            launch.run(old_fn, "base paged_attention", q.device, q.dtype,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lens.data_ptr(), None, pt.data_ptr(),
                       out_old.data_ptr(), ws.data_ptr(),
                       ws.data_ptr() + 4 * b * hq * n_split * dv, b, hq, hkv,
                       d, dv, blk, npages, split, 1.0 / math.sqrt(d),
                       launch.PAIRINGS["g_major"])
            return out_old

        def new():
            return ops.paged_attention(q, k, v, lens, pt, pairing="g_major")

        want = ref.paged_attention_ref(q[:, 0], k, v, lens, pt,
                                       pairing="g_major")
        errs = {}
        for label, fn in (("base", old), ("this", new)):
            got = fn()
            torch.cuda.synchronize()
            errs[label] = cs._check(f"{label} {name}", got[:, 0], want,
                                    cs.TOL["bfloat16"])
        nbytes = cs._decode_bytes(q, k, lens.tolist(), dv, blk) \
            + pt.numel() * 4
        bound = cs._bound(nbytes, 0, "bfloat16")
        turns = {"base": [], "this": []}
        for label in ("base", "this", "this", "base"):
            fn = old if label == "base" else new
            turns[label].append(cs.time_ms(fn, reps, flush)[0])
        ms = {k_: statistics.median(t) for k_, t in turns.items()}
        # the plain version and one SDPA call over the gathered pages
        kg, vg = ref.gather_pages(k, pt), ref.gather_pages(v, pt)
        kpos = torch.arange(kg.shape[1], device="cuda")
        mask = (kpos[None, :] < lens[:, None])[:, None, None]
        ks, vs = cs._tile_heads(kg, hq // hkv), cs._tile_heads(vg, hq // hkv)
        plain_ms = cs.time_ms(lambda: ref.paged_attention_ref(
            q[:, 0], k, v, lens, pt, pairing="g_major"), 5, flush)[0]
        library_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), ks, vs, attn_mask=mask), reps, flush)[0]
        print(json.dumps({
            "case": name, "b": b, "hq": hq, "hkv": hkv, "npages": npages,
            "lens": [int(lens.min()), int(lens.max())],
            "keys": int(lens.sum()), "base_split": [split, n_split],
            "this_plan": ops.kernel_plan(q, k, v, pt),
            "base_turns_ms": turns["base"], "this_turns_ms": turns["this"],
            "base_ms": ms["base"], "this_ms": ms["this"],
            "bound_ms": bound["bound_ms"], "bytes": nbytes,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "base_roofline_pct": 100 * bound["bound_ms"] / ms["base"],
            "this_roofline_pct": 100 * bound["bound_ms"] / ms["this"],
            "max_abs_err": errs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--cases", default="k1,k2")
    ap.add_argument("--fp8", action="store_true",
                    help="e4m3 pools against the upcast ones, this tree")
    ap.add_argument("--split", action="store_true",
                    help="with --base: the bf16 split decode of both trees "
                         "in one process, at the cells' shapes")
    args = ap.parse_args()
    if args.base is None and not args.fp8:
        ap.error("--base is required (or --fp8)")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    if args.split:
        split_ab(args.base.resolve())
        return 0
    if args.fp8:
        for r in run(ROOT, "this", "kv_fp8"):
            print(json.dumps({**{k: r.get(k) for k in IDENTITY},
                              "kv_dtype": r["kv_dtype"],
                              "upcast_turns_ms": r["upcast_turns_ms"],
                              "fp8_turns_ms": r["fp8_turns_ms"],
                              "fp8_over_upcast": r["fp8_ms"]
                              / r["upcast_ms"]}), flush=True)
        return 0
    base = args.base.resolve()
    times: dict = {}
    for label, tree in (("base", base), ("this", ROOT), ("this", ROOT),
                        ("base", base)):
        for r in run(tree, label, args.cases):
            key = json.dumps({k: r.get(k) for k in IDENTITY})
            times.setdefault(key, {}).setdefault(label, []).append(r["ms"])
    for key, t in times.items():
        print(json.dumps({**json.loads(key),
                          **{f"{lab}_ms": statistics.median(v)
                             for lab, v in t.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
