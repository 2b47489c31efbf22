"""The cost pass of the port's dry-run: the counterpart of the reference's
``hlo_analysis`` (named so that a reader finds it), which re-derives the
roofline numerators from compiled HLO text.

The port compiles nothing, so there is no HLO to read. ``analyze_step``
runs the step eagerly instead, on ``meta`` for the dry-run (shapes and
dtypes, no storage, no launch) or on the card, and counts:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over every
    aten operation of the step (matmuls, convolutions, the backward's
    torch ops), plus the work each kernel wrapper adds to
    ``kernels.work.count_work`` (FlopCounterMode cannot see a ctypes
    launch). Eager torch unrolls the layer loop, so no trip-count scaling
    is needed. Under ``remat_policy="dots"`` a checkpoint's recompute
    runs under its own dispatch mode, above these counters, which returns
    each kept product without running it: a kept product counts once, in
    the forward;
  * ``bytes_materialized``: the bytes of every tensor an aten operation
    of the step creates (views and in-place results, which alias an input,
    are not counted), the kernels' workspaces included: on ``meta`` each
    wrapper allocates the workspace its launch would, planned with the
    card's SM count (an H100's on a host without one). The reference's is
    a TPU memory model (slices always, other results past 16 MiB of VMEM);
    the two are different proxies of HBM traffic, and neither is compared
    with the other;
  * ``collectives`` / ``collective_bytes``: None. One controller holds
    whole tensors and runs no collective.

Every count is the same on ``meta`` and on the card for the same step:
``chip_smoke.py`` holds them equal.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work


class _Materialized(TorchDispatchMode):
    """Sums the bytes of the tensors each operation creates."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(r.alias_info is not None for r in func._schema.returns):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict]:
    """Run ``fn(*args, **kwargs)`` once, counting; returns (its output,
    {"dot_flops", "aten_flops", "kernel_flops" {K: operations},
    "kernel_calls" {K: calls}, "bytes_materialized", "collectives",
    "collective_bytes"})."""
    with FlopCounterMode(display=False) as fc, work.count_work() as w, \
            _Materialized() as mat:
        out = fn(*args, **kwargs)
    aten = int(fc.get_total_flops())
    return out, {"dot_flops": aten + sum(w.flops.values()),
                 "aten_flops": aten,
                 "kernel_flops": dict(sorted(w.flops.items())),
                 "kernel_calls": dict(sorted(w.calls.items())),
                 "bytes_materialized": mat.bytes,
                 "collectives": None, "collective_bytes": None}
