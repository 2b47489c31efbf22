"""Captured steps: the port's counterpart of the reference's ``jax.jit``
over its fixed-shape dispatches: the serving megastep at each bucket
width, the legacy loop's decode and chunk prefill (one per chunk width),
the dense engine's decode and prefill (one per prompt length), and the
train step (``training.train_step``: loss, gradients, clip and AdamW).

A ``CapturedStep`` records one call of a step function as a CUDA graph
(``torch.cuda.graph``) and replays it: a step is then one graph launch,
whatever the number of operators and kernels inside it, where an eager
step launches each from Python.

  * ``StaticInputs`` holds the call's static device inputs: the named int32
    arrays packed into one device buffer, whose views are the function's
    arguments, and one host twin (pinned on the card), so that staging a
    step is one host write and one H2D copy. Every stage overwrites every
    element: a narrow step never sees a wider step's stale rows.
    ``StaticTensors`` is the route for inputs that are already tensors of
    any dtype (a training batch: int32 tokens, float32 patch or frame
    embeddings): one static tensor each, staged by a copy on the device.
  * ``warm_up`` runs the function once eagerly, on the capture's side
    stream, before it is captured: the first call of a key is its warm-up
    and gives that call's result, as ``jax.jit`` traces, compiles and runs
    at first call.
  * ``capture_cuda`` captures on that stream into a memory pool the
    caller shares between its graphs (``torch.cuda.graph_pool_handle()``).
    Graphs of one pool may reuse each other's intermediates, and a later
    capture may place its output where an earlier graph keeps scratch. That
    is safe only because each step's output is read to the host before the
    next replay of any graph of the pool; every caller here does so.
  * ``capture_eager`` is the stand-in of the CPU: its "graph" runs the
    function again on each replay, so the staged-buffer route runs there
    without a card.

Launch accounting: a replay runs no Python, so the kernel wrappers'
``launches`` counters would not move. ``CapturedStep`` records how much
each grew while the function was captured (capture launches nothing, so
the counters are put back), and each replay adds that delta: a count keeps
meaning the launches the card ran.

Nothing falls back: a capture or replay that fails raises.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.ssd import ops as ssd


def launch_counters() -> tuple:
    """Every kernel wrapper whose ``launches`` counts its launches."""
    return (pa.paged_prefill_attention, pa.paged_attention,
            fa.flash_attention, da.decode_attention, ssd.ssd)


class StaticInputs:
    """One call signature's inputs: ``shapes`` {name: shape} of int32
    arrays (bool arrays stage as 0/1), packed in that order into one
    device buffer; ``views[name]`` is each input's view of it."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], device):
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        sizes = [math.prod(s) for s in self.shapes.values()]
        n = sum(sizes)
        self.host = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
        self._host = self.host.numpy()
        self.buffer = torch.zeros(n, dtype=torch.int32, device=self.device)
        self.views: Dict[str, torch.Tensor] = {}
        self._slices: Dict[str, slice] = {}
        off = 0
        for (name, shape), size in zip(self.shapes.items(), sizes):
            self._slices[name] = slice(off, off + size)
            self.views[name] = self.buffer[off:off + size].view(shape)
            off += size
        # the last H2D copy out of the host twin: the next stage waits for
        # it before writing the twin again
        self._copied = torch.cuda.Event() if cuda else None

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        """Write every input (each exactly its shape) into the host twin,
        then copy the whole buffer to the device on the current stream."""
        if arrays.keys() != self.shapes.keys():
            raise ValueError(f"inputs {sorted(arrays)}, expected "
                             f"{sorted(self.shapes)}")
        for name, a in arrays.items():
            if a.shape != self.shapes[name]:
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{self.shapes[name]}")
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            self._host[self._slices[name]] = a.reshape(-1)
        self.buffer.copy_(self.host, non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record()


class StaticTensors:
    """One call signature's tensor inputs ``{name: tensor}``, each kept in
    its own shape and dtype as one static tensor on ``device``;
    ``views[name]`` is that tensor. ``stage`` copies each input in on the
    current stream (device to device where the input lies on the card)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device):
        self.device = torch.device(device)
        self.views: Dict[str, torch.Tensor] = {
            n: torch.empty(t.shape, dtype=t.dtype, device=self.device)
            for n, t in tensors.items()}

    def stage(self, tensors: Dict[str, torch.Tensor]) -> None:
        if tensors.keys() != self.views.keys():
            raise ValueError(f"inputs {sorted(tensors)}, expected "
                             f"{sorted(self.views)}")
        for name, t in tensors.items():
            v = self.views[name]
            if t.shape != v.shape or t.dtype != v.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                                 f"expected {tuple(v.shape)} {v.dtype}")
        for name, t in tensors.items():
            self.views[name].copy_(t)


def static_inputs(arrays: Dict, device):
    """The static inputs for ``arrays``: ``StaticTensors`` where every
    value is a tensor, else ``StaticInputs`` over the numpy arrays."""
    if all(isinstance(a, torch.Tensor) for a in arrays.values()):
        return StaticTensors(arrays, device)
    return StaticInputs({n: a.shape for n, a in arrays.items()}, device)


def warm_up(fn: Callable, device, stream=None):
    """``fn()`` run eagerly; on the card on ``stream`` (the capture's side
    stream), ordered after and before the current stream's work."""
    if stream is None:
        return fn()
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


class _CudaGraph:
    def __init__(self, graph, out):
        self.graph, self.out = graph, out

    def replay(self):
        self.graph.replay()
        return self.out


def capture_cuda(fn: Callable, device, pool=None, stream=None):
    """``fn`` captured as a CUDA graph on ``stream`` into ``pool``;
    ``replay()`` launches it and returns its (static) output."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        out = fn()
    return _CudaGraph(graph, out)


class _Eager:
    def __init__(self, fn):
        self.replay = fn


def capture_eager(fn: Callable, device, pool=None, stream=None):
    """The CPU's stand-in for ``capture_cuda``: records nothing, and each
    ``replay()`` runs ``fn`` eagerly."""
    return _Eager(fn)


def pool_bytes(device, pool) -> Optional[int]:
    """Bytes the caching allocator holds for graph memory pool ``pool`` on
    ``device`` (its segments in ``torch.cuda.memory_snapshot()``); None
    where the snapshot does not name pools."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    segs = [s for s in torch.cuda.memory_snapshot() if s["device"] == idx]
    if not all("segment_pool_id" in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


class CapturedStep:
    """``fn(**inputs.views)`` (``fn()`` without inputs; ``inputs`` a
    ``StaticInputs`` or ``StaticTensors``) captured with ``capture``;
    calling it stages the arrays, replays and returns the
    output. ``launch_delta`` {wrapper: launches per replay},
    ``capture_s`` and ``pool_growth`` (bytes the capture added to the
    pool on the card, None elsewhere) describe it."""

    def __init__(self, fn: Callable, inputs,
                 device, *, capture=capture_cuda, pool=None, stream=None):
        self.inputs = inputs
        views = inputs.views if inputs is not None else {}
        on_card = capture is capture_cuda
        before_pool = pool_bytes(device, pool) if on_card else None
        counters = launch_counters()
        before = [w.launches for w in counters]
        t0 = time.perf_counter()
        try:
            self.graph = capture(lambda: fn(**views), device, pool, stream)
        finally:
            grew = [w.launches - b for w, b in zip(counters, before)]
            for w, b in zip(counters, before):
                w.launches = b
        self.capture_s = time.perf_counter() - t0
        self.launch_delta = {w: d for w, d in zip(counters, grew) if d}
        after_pool = pool_bytes(device, pool) if on_card else None
        self.pool_growth = (after_pool - before_pool
                            if None not in (before_pool, after_pool)
                            else None)

    def stage(self, arrays: Optional[Dict] = None) -> None:
        if self.inputs is not None:
            self.inputs.stage(arrays)

    def replay(self):
        out = self.graph.replay()
        for w, d in self.launch_delta.items():
            w.launches += d
        return out

    def __call__(self, arrays: Optional[Dict] = None):
        self.stage(arrays)
        return self.replay()


class StepGraphs:
    """One engine's captured steps, by key, sharing one memory pool and one
    side stream on the card. ``run(key, fn, arrays)`` replays the key's
    step, or at its first call stages ``arrays``, warms ``fn`` up (that
    call's result) and captures it; ``stage`` does the staging alone and
    returns the rest as a call, so that a caller can time the two apart.
    ``fn`` takes the arrays' names as
    keyword tensors; ``arrays`` (numpy int32 arrays, or tensors of any
    dtype: ``static_inputs``) None means ``fn()`` reads persistent
    tensors of its own. ``capture`` is ``capture_cuda`` on the card,
    ``capture_eager`` for the staged route on the CPU. The counts in
    ``stats()`` run over the object's life, across ``clear()``."""

    def __init__(self, device, capture=capture_cuda):
        self.device = torch.device(device)
        self.capture = capture
        self.on_card = capture is capture_cuda
        self.stream = torch.cuda.Stream(self.device) if self.on_card \
            else None
        self.steps: Dict = {}
        self._new_pool()
        self.first_calls = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_growth: Dict[str, Optional[int]] = {}

    def _new_pool(self):
        # a pool id whose graphs are all gone may not be captured into
        # again, so each generation of graphs takes a fresh one
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None

    def run(self, key, fn: Callable,
            arrays: Optional[Dict] = None):
        return self.stage(key, fn, arrays)()

    def stage(self, key, fn: Callable,
              arrays: Optional[Dict] = None) -> Callable:
        """A captured key: ``arrays`` staged and its replay returned; a
        first call: ``run``'s first call, returned unrun."""
        step = self.steps.get(key)
        if step is None:
            return lambda: self._first_call(key, fn, arrays)
        step.stage(arrays)
        self.replays += 1
        return step.replay

    def _first_call(self, key, fn: Callable, arrays: Optional[Dict]):
        inputs = None
        if arrays is not None:
            inputs = static_inputs(arrays, self.device)
            inputs.stage(arrays)
        views = inputs.views if inputs is not None else {}
        out = warm_up(lambda: fn(**views), self.device, self.stream)
        step = self.steps[key] = CapturedStep(
            fn, inputs, self.device, capture=self.capture, pool=self.pool,
            stream=self.stream)
        self.first_calls += 1
        self.capture_s += step.capture_s
        self.pool_growth[str(key)] = step.pool_growth
        return out

    def clear(self):
        """Drop every captured step (their pool goes with them): the next
        call of each key captures anew."""
        self.steps.clear()
        self._new_pool()

    def stats(self) -> Dict:
        return {"graphs": len(self.steps), "first_calls": self.first_calls,
                "replays": self.replays, "capture_s": self.capture_s,
                "pool_growth_bytes": dict(self.pool_growth)}
