"""The device peaks the benchmark holds every kind's work counts against
(the data sheet's: NVIDIA H100 SXM, dense, no sparsity). The counts
themselves are each kind's (``agentbench/kinds``)."""
from __future__ import annotations

from typing import Optional, Tuple

# name as torch.cuda.get_device_name() gives it -> (bf16 FLOP/s, HBM B/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, HBM bytes/s) of a card, or None for one not listed."""
    return PEAKS.get(device_name)
