"""Meshes of the port: a grid of devices with named axes, the counterpart of
``jax.sharding.Mesh`` (the port of ``repro.launch.mesh``).

One process drives every position of a mesh, as the reference's single
controller does. A device may repeat, so several positions share one card,
the CPU or ``meta``: the counterpart of the reference's forced host
devices. Three constructors:

  * ``make_production_mesh``: the dry-run's 16x16 ``("data", "model")`` or
    2x16x16 ``("pod", "data", "model")`` mesh, on ``meta`` by default,
    which allocates nothing;
  * ``make_local_mesh``: 1 x n ``("data", "model")`` over the visible
    devices;
  * ``make_tp_mesh``: the serving megastep's 1-D ``("tp",)`` mesh
    (DESIGN.md §13), a ``TPMesh``.

``with mesh:`` makes a mesh the active one of its thread (``active_mesh``),
as the reference's ``with mesh:`` does for jax.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import TP

_active = threading.local()


class Mesh:
    """``devices`` (row-major, one per position) laid out on a grid of
    ``dims`` named ``axis_names``. ``shape`` maps each axis to its size;
    ``devices`` is the grid as nested tuples (a flat tuple for one axis)."""

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        self.dims = tuple(int(n) for n in dims)
        self.axis_names = tuple(axis_names)
        self.flat_devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"{len(self.dims)} dims for axes "
                             f"{self.axis_names}")
        if math.prod(self.dims) != len(self.flat_devices):
            raise ValueError(f"a {self.dims} mesh needs "
                             f"{math.prod(self.dims)} devices, got "
                             f"{len(self.flat_devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.flat_devices)

    @property
    def devices(self) -> tuple:
        def nest(flat, dims):
            if len(dims) == 1:
                return tuple(flat)
            step = len(flat) // dims[0]
            return tuple(nest(flat[i * step:(i + 1) * step], dims[1:])
                         for i in range(dims[0]))
        return nest(self.flat_devices, self.dims)

    def positions(self) -> Iterator[Tuple[Dict[str, int], torch.device]]:
        """(coordinates {axis: index}, device) of every position, in
        row-major order."""
        for i, dev in enumerate(self.flat_devices):
            coords, rest = {}, i
            for name, n in reversed(list(zip(self.axis_names, self.dims))):
                coords[name] = rest % n
                rest //= n
            yield {a: coords[a] for a in self.axis_names}, dev

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _active.stack.pop()
        return False

    def __repr__(self):
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        distinct = sorted(set(map(str, self.flat_devices)))
        return f"Mesh({shape}, devices={distinct})"


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread, or
    None."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


class TPMesh(Mesh):
    """``tp`` shards, shard ``i`` on ``devices[i]``: the 1-D ``("tp",)``
    mesh. Engine code reads ``mesh.shape[TP]``, ``mesh.axis_names`` and
    ``mesh.devices`` as the reference does."""

    def __init__(self, devices: Sequence[torch.device]):
        super().__init__((len(devices),), (TP,), devices)

    def __repr__(self):
        return f"TPMesh(tp={self.size}, devices={list(self.flat_devices)})"


def _indexed(device) -> torch.device:
    """``device`` resolved (a ``cuda`` device with no GPU raises), a CUDA
    device given its index so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible(device) -> list:
    """The devices of ``device``'s type this host has: every CUDA card, or
    the one CPU or ``meta``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """16x16 ``("data", "model")``, or 2x16x16 ``("pod", "data", "model")``
    with ``multi_pod``: every position on ``device`` (``meta``: the
    dry-run's placeholder, which allocates nothing)."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = _indexed(device)
    return Mesh(dims, axes, [dev] * math.prod(dims))


def make_local_mesh(device="cuda", devices=None) -> Mesh:
    """1 x n ``("data", "model")`` over the visible devices of ``device``'s
    type (the CPU counts as one), or over ``devices``, repeats allowed. A
    ``cuda`` device on a host without a GPU raises; nothing falls back to
    the CPU."""
    devs = ([_indexed(d) for d in devices] if devices is not None
            else _visible(device))
    if not devs:
        raise ValueError("a local mesh needs at least one device")
    return Mesh((1, len(devs)), ("data", "model"), devs)


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
    visible = _visible(device)
    if tp > len(visible):
        raise ValueError(
            f"tp={tp} exceeds the {len(visible)} visible device(s); pass "
            "devices=[...] (repeats allowed) to run several shards on one "
            "device")
    return TPMesh(visible[:tp])
