"""Atomic, resumable checkpointing, the port of
``repro.checkpoint.checkpointer`` with its layout and guarantees:

    <dir>/step_<N>/
        manifest.json   — step, tree structure, each leaf's shape and dtype
        proc0.npz       — the leaves, ``leaf_00000`` ... in JAX's order

  * atomic publish: written to step_<N>.tmp, then ``os.replace``d, so a
    crash mid-write never corrupts the latest checkpoint;
  * bitwise resume: ``restore`` returns exactly what ``save`` saw;
  * the leaves are walked in JAX's order (``repro_torch.tree``: dict keys
    sorted, NamedTuple fields in order, ``None`` holding none), so a
    checkpoint either package writes restores in the other;
  * ``restore`` returns host tensors, and the caller places them
    (``distributed.sharding.elastic_restore``);
  * retention: ``keep_last`` prunes old steps only after a publish.

bf16 leaves are stored as their raw bits (``uint16``), as
``weights.torch_to_numpy`` gives them. One process writes ``proc0.npz``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.tree import flatten, unflatten
from repro_torch.weights import numpy_to_torch, torch_to_numpy


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Any]:
    flat, spec = flatten(tree)
    keys = [f"leaf_{i:05d}" for i in range(len(flat))]
    return dict(zip(keys, [torch_to_numpy(t) for t in flat])), spec


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        flat, spec = _flatten(tree)
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "proc0.npz"), **flat)
        manifest = {
            "step": step,
            "treedef": str(spec),
            "n_leaves": len(flat),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``like`` (a tree of tensors):
        returns (tree of CPU tensors in ``like``'s dtypes, step, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like, spec = flatten(like)
        if len(flat_like) != manifest["n_leaves"]:
            raise ValueError(f"leaf count mismatch: {len(flat_like)} vs "
                             f"{manifest['n_leaves']}")
        out = []
        with np.load(os.path.join(path, "proc0.npz")) as data:
            for i, ref in enumerate(flat_like):
                t = numpy_to_torch(data[f"leaf_{i:05d}"])
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: shape {tuple(t.shape)} in "
                                     f"the checkpoint, {tuple(ref.shape)} "
                                     "expected")
                out.append(t.to(ref.dtype))
        return unflatten(spec, out), step, manifest["extra"]
