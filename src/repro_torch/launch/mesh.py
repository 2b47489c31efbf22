"""The serving mesh: a 1-D ``("tp",)`` tensor-parallel mesh for the sharded
megastep (DESIGN.md §13), the port of ``repro.launch.mesh.make_tp_mesh``.

One process drives every shard, as the reference's single ``shard_map``
does. The mesh is an ordered list of devices, one per shard; a device may
repeat (``devices=[...]``), so several shards share one card or the CPU:
the counterpart of the reference's forced host devices. The dry-run's
production and local meshes are not here.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import TP


class TPMesh:
    """``tp`` shards, shard ``i`` on ``devices[i]``. Engine code reads
    ``mesh.shape[TP]`` and ``mesh.axis_names`` as the reference does."""

    axis_names = (TP,)

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: Tuple[torch.device, ...] = tuple(devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {TP: len(self.devices)}

    def __repr__(self):
        return f"TPMesh(tp={len(self.devices)}, devices={list(self.devices)})"


def _indexed(device) -> torch.device:
    """``device`` resolved (a ``cuda`` device with no GPU raises), a CUDA
    device given its index so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_tp_mesh(tp: int, device="cuda", devices=None) -> TPMesh:
    """1-D tensor-parallel mesh of ``tp`` shards. Without ``devices``, the
    first ``tp`` visible devices of ``device``'s type (the CPU counts as
    one), and a ValueError when there are fewer, so launchers can surface
    it as a CLI error. ``devices`` lists one device per shard, repeats
    allowed. A ``cuda`` device on a host without a GPU raises; nothing
    falls back to the CPU."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if devices is not None:
        devices = [_indexed(d) for d in devices]
        if len(devices) != tp:
            raise ValueError(f"tp={tp} needs one device per shard, got "
                             f"{len(devices)}")
        return TPMesh(devices)
    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    if tp > len(visible):
        raise ValueError(
            f"tp={tp} exceeds the {len(visible)} visible device(s); pass "
            "devices=[...] (repeats allowed) to run several shards on one "
            "device")
    return TPMesh(visible[:tp])
