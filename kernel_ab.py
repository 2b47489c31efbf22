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
"""
from __future__ import annotations

import argparse
import json
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--cases", default="k1,k2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
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
