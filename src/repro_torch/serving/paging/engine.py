"""PagedInferenceEngine: continuous batching over the paged KV cache.

The port of ``repro.serving.paging.engine`` on its megastep path:

  * Admission is by **blocks, not slots**: what gates a request is whether
    the block pool can hold its first chunk, not a max_len reservation.
  * Prefill is **chunked** (Sarathi-style) and fused with decode: every
    iteration packs one (max_batch, C) token matrix — decode rows are
    width-1 prefill rows — and makes ONE ``mixed_step_paged`` call. Greedy
    sampling is part of that call, so one (max_batch,) int32 vector is the
    only device-to-host transfer per step.
  * With a ``token_budget`` the pack is **decode-first** and the dispatch
    width C comes from the bounded pow2 bucket set ``budget_buckets``. A
    bucket whose (max_batch, C) batch holds more slots than the largest
    bucket runs its dense layers on that many flat slots instead
    (``flat_width``, ``mixed_step_paged``'s ``flat``); K1 keeps the batch.
  * Sessions are first-class: retained (parked) between turns, ``extend``ed
    by a later turn, ``fork``ed copy-on-write, prompt prefixes deduplicated.
  * Scheduling hooks: ``park``/``resume`` (bit-exact), ``abort_turn``
    between steps, ``hibernate``/``wake`` through the host swap tier, and
    ``export_live``/``import_live`` payloads in the reference's layout.

On CUDA tensors every layer's attention is the hand-written Hopper kernel.
``megastep=False`` keeps the reference's legacy loop as the benchmark
baseline: one ``prefill_chunk_paged`` call per prefilling sequence plus one
batched ``decode_step_paged`` call per step, with the full (max_batch,
vocab) float32 logits crossing to the host and sampled there.

Compiled dispatch (``cuda_graphs``, the counterpart of the reference's
``jax.jit`` + ``compile_buckets``): on the card, with every shard on one
device, each megastep bucket width, the legacy loop's decode and its
chunked prefill (one graph per chunk width, its ``cache_len`` and
``valid`` staged as (1,) int32 device inputs, as the reference traces
them as dynamic values) is one CUDA graph (``serving.graphs``), captured
by ``compile_buckets`` or at its first call and replayed over static,
fully restaged inputs; a dispatch is then one graph launch.

``mesh=`` (a ``launch.mesh.make_tp_mesh`` mesh, DESIGN.md §13) makes the
megastep tensor-parallel: the params are head-permuted and sliced per
shard (``distributed.sharding.shard_serving_params``), the KV pools split
over the KV heads, and each step is still ONE ``mixed_step_paged`` call
(its ``shards``) with one (max_batch,) int32 vector to the host; inside
it K1 runs once per shard per layer at the local head counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context.tiers import KVSwapStore
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import (TP, shard_serving_params,
                                              validate_tp)
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import build
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import check_gqa_family
from repro_torch.obs import LATENCY_BUCKETS_S, Observability
from repro_torch.serving import graphs
from repro_torch.serving.paging.allocator import (NULL_BLOCK,
                                                  OutOfBlocksError,
                                                  PageTable)
from repro_torch.serving.paging.pool import PagedKVCache
from repro_torch.serving.paging.swap import SwapManager
# EngineError is re-exported here, as the reference's engine does
from repro_torch.serving.errors import (EngineError, KVPressureError,
                                        PoisonedRowError, SwapIOError)

QUEUED, ACTIVE, PARKED, SWAPPED, FREED = \
    "queued", "active", "parked", "swapped", "freed"

# a megastep's host phases, in order, each an ``engine.<phase>`` span on the
# flight recorder's megastep track: admission, the (rows, C) pack, staging
# the inputs (host twin and H2D copy), the launch (the graph's replay, or
# the eager call), waiting on the device for the sampled ids, bookkeeping
PHASES = ("admit", "pack", "stage", "launch", "readback", "bookkeep")


# minimum non-decode dispatch width, kept equal to the reference's (there it
# is the Pallas sublane width) so both engines draw C from the same set
_MIN_CHUNK_BUCKET = 8


def budget_buckets(token_budget: int) -> Tuple[int, ...]:
    """The bounded bucket set for a token budget: {1} for pure-decode
    iterations, then powers of two from 8 up to the budget itself. Every
    megastep dispatch width is drawn from this set, so the number of
    distinct step shapes is capped at ``len(budget_buckets(B))`` no matter
    how ragged the live workload mix is."""
    buckets = [1]
    w = _MIN_CHUNK_BUCKET
    while w < token_budget:
        buckets.append(w)
        w *= 2
    if token_budget > 1:
        buckets.append(token_budget)
    return tuple(dict.fromkeys(buckets))


@dataclasses.dataclass(eq=False)
class PagedRequest:
    rid: int
    prompt: np.ndarray                       # (S,) int32
    max_new_tokens: int = 16
    retain: bool = False
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    # input tokens not yet written to the cache: the whole prompt for a
    # fresh request, [previous last_tok] + new prompt tokens for an extend.
    pending: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    table: Optional[PageTable] = None
    last_tok: int = 0                        # next input token once pending=[]
    state: str = QUEUED
    done: bool = False                       # current turn finished
    # True only while the ORIGINAL prompt is being written (first turn,
    # never extended): the prefix-dedup index may only be fed from this
    # window — extend turns write non-prompt tokens at positions that a
    # prompt-keyed index entry would misdescribe.
    fresh_turn: bool = True
    # wall-clock latency bookkeeping for the current turn: when it was
    # enqueued and when its previous output token landed (None before the
    # first) — feeds the engine's TTFT / inter-token-latency samples
    t_enqueue: float = 0.0
    t_last_tok: Optional[float] = None
    # start of the CURRENT admission wait (enqueue/extend/resume); unlike
    # t_enqueue it restarts on resume so the flight recorder's queued span
    # covers one wait episode, not the whole turn
    t_queued: float = 0.0

    @property
    def num_tokens(self) -> int:
        return self.table.num_tokens if self.table is not None else 0

    @property
    def prefilling(self) -> bool:
        return bool(self.pending)


class PagedInferenceEngine:
    """Greedy-decode engine for the decoder-only GQA family over a paged KV
    cache (block allocator + page tables + swap tier)."""

    def __init__(self, cfg: ModelConfig, params, *, num_blocks: int = 64,
                 block_size: int = 16, max_batch: int = 8,
                 max_len: int = 256, prefill_chunk: int = 32,
                 token_budget: Optional[int] = None,
                 swap_store: Optional[KVSwapStore] = None,
                 megastep: bool = True,
                 mesh=None,
                 obs: Optional[Observability] = None,
                 name: str = "engine",
                 device="cuda",
                 cuda_graphs: Optional[bool] = None):
        check_gqa_family(cfg)
        self.cfg = cfg
        # fleet members get distinct names ("engine0", "engine1", ...) so
        # a shared Observability keeps per-engine metric namespaces and
        # Perfetto track groups; the default keeps every single-engine
        # metric name byte-identical to before
        self.name = name
        self.model = build(cfg)
        # ---- tensor-parallel mesh (DESIGN.md §13) ------------------------
        # mesh=None is the single-device engine. With a ("tp",) mesh each
        # step is still ONE mixed_step_paged call: KV pools split over the
        # hkv axis, row inputs replicated, the attention partials summed
        # once per layer. Validation raises ValueError so launchers surface
        # mesh-shape mistakes as CLI errors. The mesh's devices place the
        # engine (``device`` is not read then).
        self.mesh = mesh
        self.tp = 1
        if mesh is not None:
            if TP not in dict(mesh.shape):
                raise ValueError(
                    f"mesh axes {tuple(mesh.axis_names)} lack the '{TP}' "
                    "axis the sharded megastep partitions heads over")
            if not megastep:
                raise ValueError(
                    "mesh requires the megastep (megastep=True): the "
                    "legacy per-sequence dispatch loop is single-device")
            validate_tp(cfg, mesh.shape[TP])
            self.tp = mesh.shape[TP]
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        # ---- compiled dispatch: None -> graphs on the card when every
        # shard is on one device (one graph holds the whole tp step);
        # False is the eager step, as ``jax.disable_jit()`` is the
        # reference's, kept for same-call A/Bs and parity checks
        devs = set(mesh.flat_devices) if mesh is not None else {self.device}
        graphable = self.device.type == "cuda" and len(devs) == 1
        if cuda_graphs is None:
            cuda_graphs = graphable
        elif cuda_graphs and not graphable:
            raise ValueError(
                "cuda_graphs=True needs one CUDA device holding every "
                f"shard, not {sorted(map(str, devs))}")
        self.cuda_graphs = bool(cuda_graphs)
        # the engine's captured steps (None: the eager route); a graph
        # holds raw pool pointers, so _dispatch drops them all when
        # ``cache.set_pools`` rebinds the pools
        self.graphs = (graphs.StepGraphs(self.device) if self.cuda_graphs
                       else None)
        self._graph_pools: tuple = ()
        if mesh is not None:
            # head-permute (identity at tp=1) and slice: one param tree
            # per shard
            params = shard_serving_params(cfg, mesh, params)
        self.params = params
        self.max_batch = max_batch
        self.max_len = min(max_len, (num_blocks - 1) * block_size)
        self.prefill_chunk = max(1, min(prefill_chunk, self.max_len))
        # ---- stall-free token budget (DESIGN.md §11) ---------------------
        # token_budget caps the total tokens one megastep may process.
        # budget >= max_batch guarantees the decode-first pack always fits
        # every decoding row AND leaves >= 1 token for every prefilling row
        # (n_decode + n_prefill <= max_batch <= budget), so no active row
        # ever starves. None keeps the fixed-chunk behaviour.
        if token_budget is not None:
            if token_budget < max_batch:
                raise ValueError(
                    f"token_budget {token_budget} < max_batch {max_batch}: "
                    "the decode-first pack needs one token per batch row "
                    "to keep every active sequence stall-free")
            token_budget = min(token_budget, self.max_len)
            self.bucket_set = budget_buckets(token_budget)
        else:
            # legacy two-bucket megastep: C in {1, prefill_chunk}
            self.bucket_set = tuple(
                dict.fromkeys((1, self.prefill_chunk)))
        self.token_budget = token_budget
        # admission reserves blocks for the FIRST dispatch's worth of prompt
        # only; with a budget smaller than the chunk that is the budget —
        # reserving chunk-width blocks would over-reserve
        self.first_chunk_cap = (min(self.prefill_chunk, token_budget)
                                if token_budget else self.prefill_chunk)
        self.cache = PagedKVCache(cfg, num_blocks, block_size,
                                  device=self.device, mesh=mesh)
        # megastep=True (default): ONE mixed_step_paged call per engine
        # iteration. megastep=False keeps the legacy loop (one
        # prefill_chunk_paged call per prefilling sequence plus a
        # decode_step_paged call) as the benchmark baseline.
        self.use_megastep = megastep
        self.swap = SwapManager(self.cache, swap_store,
                                on_evict=self._on_evicted)
        self.max_pages = self.cache.pages_for(self.max_len)
        self.reqs: Dict[int, PagedRequest] = {}
        self.active: Dict[int, PagedRequest] = {}
        self.free_slots = list(range(max_batch))
        self._queue: List[PagedRequest] = []
        self._next_rid = 0
        # ---- observability (DESIGN.md §12): one registry + flight
        # recorder per serving stack. The registry is the SINGLE store for
        # every engine counter below (the attributes are properties over
        # registry metrics), so step_stats()/kv_stats()/BENCH jsons can
        # never diverge from it. Tracing is off unless the caller's
        # TraceConfig enables it.
        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        # dispatch accounting for the perf contract: jit_dispatches counts
        # mixed_step_paged calls (the reference's jitted dispatches; the name
        # is kept so both engines publish the same metrics),
        # steps_dispatched counts step()s that ran any — the megastep
        # invariant is jit_dispatches_per_step == 1.0
        self._c_jit = m.counter(f"{name}.jit_dispatches")
        self._c_steps = m.counter(f"{name}.steps_dispatched")
        self._c_decode_steps = m.counter(f"{name}.decode_steps")
        # bucket / padding accounting: every distinct megastep width C is
        # one step shape, so len(trace_buckets) <= len(bucket_set) is the
        # guard that live traffic stays inside what compile_buckets ran.
        # tokens_real counts tokens the workload actually needed;
        # tokens_dispatched counts the (rows x width) token slots each step
        # paid FLOPs for — their gap is the padding the budget packer
        # exists to shrink.
        self.trace_buckets: set = set()
        self.compiled_buckets: set = set()   # pre-traced by compile_buckets
        self._c_tokens_real = m.counter(f"{name}.tokens_real")
        self._c_tokens_disp = m.counter(f"{name}.tokens_dispatched")
        # tokens_dispatched still counts the (rows x width) slots K1
        # computes; the dense layers may run on fewer: dense_slots sums the
        # slots they ran on (flat_width), flat_steps counts the steps where
        # those were fewer than rows x width (mixed_step_paged's ``flat``)
        self._c_flat_steps = m.counter(f"{name}.flat_steps")
        self._c_dense_slots = m.counter(f"{name}.dense_slots")
        # wall-clock latency distributions (seconds): time-to-first-token
        # per turn, the gap between consecutive output tokens of one turn,
        # and host wall time around each work-doing step. Fixed log-spaced
        # buckets + a bounded reservoir — a long-lived engine no longer
        # grows per-token Python lists forever.
        self.h_ttft = m.histogram(f"{name}.ttft_s", LATENCY_BUCKETS_S,
                                  reservoir=512)
        self.h_itl = m.histogram(f"{name}.itl_s", LATENCY_BUCKETS_S,
                                 reservoir=512)
        self.h_step = m.histogram(f"{name}.step_s", LATENCY_BUCKETS_S,
                                  reservoir=256)
        self.last_serviced: Dict[int, int] = {}   # rid -> tokens, last step
        # per-step casualty list: (rid, EngineError) — sequences whose turn
        # this step killed (KV pressure after reclaim, a poisoned logits
        # row, a corrupted swap payload), each aborted individually so one
        # sequence's failure never takes down its batchmates. The error is
        # the typed instance itself so the middleware can dispatch on class.
        self.last_failures: List[tuple] = []
        # rows armed for logit poisoning on their next dispatch (seeded
        # chaos injection — consumed per-rid) + fault counters (§14)
        self._poison_rids: set = set()
        self._c_poisoned = m.counter(f"{name}.poisoned_rows")
        self._c_kv_aborts = m.counter(f"{name}.kv_pressure_aborts")
        self._c_swap_fail = m.counter(f"{name}.swap_io_failures")

        # flight-recorder interning (once, here — the hot path only passes
        # ints). Tracks: one engine row for megasteps, one row per batch
        # slot, one row per session (lazily, at submit).
        rec = self.obs.recorder
        self._tr_step = rec.track("megastep", group=name)
        self._tr_rows = [rec.track(f"row {s}", group=f"{name} rows")
                         for s in range(max_batch)]
        self._sess_tracks: Dict[int, int] = {}
        # a megastep's span and the host phases inside it share the step's
        # sequence number (``step()`` calls); ``engine.admit`` ends where
        # the megastep's span begins, and pack .. bookkeep tile that span
        self._seq = 0
        self._ev_step = rec.name("engine.megastep",
                                 ("seq", "C", "rows", "tokens_real"))
        self._ev_phases = [rec.name(f"engine.{p}", ("seq", "C", "rows"))
                           for p in PHASES]
        # one instant per sharded megastep: mesh shape + per-shard work +
        # an estimate of what the per-layer sums of the attention partials
        # moved. Emitted only when tp > 1, so single-device traces are
        # byte-identical to before.
        self._tr_coll = rec.track("collectives", group=name)
        self._ev_psum = rec.name(
            "collective.psum",
            ("tp", "psums", "bytes_per_shard", "shard_tokens_dispatched"))
        self._ev_legacy = rec.name("engine.step.legacy",
                                   ("dispatches", "tokens_real"))
        self._ev_row = rec.name("row.work", ("rid", "tokens", "prefill"))
        self._ev_enq = rec.name("session.enqueued", ("rid", "pending"))
        self._ev_queued = rec.name("session.queued", ("rid",))
        self._ev_admit = rec.name("session.admitted", ("rid",))
        self._ev_prefill = rec.name("session.prefill_chunk",
                                    ("rid", "tokens", "cache_len"))
        self._ev_token = rec.name("session.token", ("rid", "n_out"))
        self._ev_park = rec.name("session.parked", ("rid",))
        self._ev_resume = rec.name("session.resumed", ("rid",))
        self._ev_swap_out = rec.name("session.swapped_out", ("rid",))
        self._ev_wake = rec.name("session.woken", ("rid",))
        self._ev_turn = rec.name("session.turn", ("rid", "out_tokens"))
        self._ev_abort = rec.name("session.aborted", ("rid",))
        self._ev_finish = rec.name("session.finished",
                                   ("rid", "out_tokens"))
        self._mega = self._build_mega()

    def _build_mega(self):
        """The one call per iteration: ``(toks, lens, valids, tables,
        poison) -> (max_batch,) int32 ids`` (poison bool or 0/1),
        ``mixed_step_paged`` over the shards (one without a mesh), each
        with its local cfg (head counts divided by tp, ``head_dim`` pinned:
        a config that leaves it 0 derives d_model // n_heads, which would
        silently grow as the local head count shrinks), its param tree and
        the cache's pools as they are at the call (``set_pools`` may have
        rebound them since)."""
        cfg = self.cfg
        lcfg = cfg.replace(n_heads=cfg.n_heads // self.tp,
                           n_kv_heads=cfg.n_kv_heads // self.tp,
                           head_dim=cfg.resolved_head_dim)
        trees = self.params if self.mesh is not None else [self.params]
        # the slots each bucket's dense layers run on: at most the largest
        # bucket, which no step's real tokens exceed (a live retune only
        # lowers the budget inside the set), or max_batch where max_len
        # clamped the budget below it (each decode row takes its token)
        cap = (max(self.bucket_set[-1], self.max_batch)
               if self.token_budget is not None else None)
        self.flat_width = {C: tr.dense_width(trees[0]["layers"],
                                             self.max_batch, C, cap)
                           for C in self.bucket_set}

        def mega(toks, lens, valids, tables, poison):
            shards = [tr.Shard(lcfg, p, pools)
                      for p, pools in zip(trees, self.cache.pools())]
            return tr.mixed_step_paged(None, None, toks, lens, valids,
                                       tables, cfg, poison.bool(),
                                       shards=shards,
                                       flat=self.flat_width[toks.shape[1]])
        return mega

    def _decode(self, toks, lens, tables):
        """The legacy loop's batched decode: (max_batch, 1, vocab) f32
        logits."""
        return self.model.decode_step_paged(self.params,
                                            self.cache.pools()[0], toks,
                                            lens, tables)

    def _chunk(self, toks, cache_len, valid, table):
        """The legacy loop's chunked prefill of one sequence: (1, C, vocab)
        f32 logits; ``cache_len`` / ``valid`` (1,) int32 on the device."""
        return self.model.prefill_chunk_paged(self.params,
                                              self.cache.pools()[0], toks,
                                              cache_len, valid, table)

    def _stage(self, key, fn, arrays: Dict[str, np.ndarray]):
        """``fn`` over ``arrays`` made ready, and the call that launches
        it: on the eager route the arrays as fresh device tensors, else
        staged into ``key``'s captured step (captured at its first call,
        which the returned call makes). The captured steps are dropped
        first if the cache's pools are no longer the tensors they were
        captured over (``set_pools``), as jit retraces on new buffers."""
        if self.graphs is None:
            ins = {n: torch.from_numpy(a).to(self.device)
                   for n, a in arrays.items()}
            return lambda: fn(**ins)
        pools = tuple(t.data_ptr() for shard in self.cache.pools()
                      for t in (shard["k"], shard["v"]))
        if pools != self._graph_pools:
            self.graphs.clear()
            self._graph_pools = pools
        return self.graphs.stage(key, fn, arrays)

    def _dispatch(self, key, fn, arrays: Dict[str, np.ndarray]):
        """``fn`` over ``arrays``, staged and launched (``_stage``)."""
        return self._stage(key, fn, arrays)()

    def _null_inputs(self, C: int) -> Dict[str, np.ndarray]:
        """A megastep's inputs with no live row: every write lands in the
        null block."""
        B = self.max_batch
        return {"toks": np.zeros((B, C), np.int32),
                "lens": np.zeros((B,), np.int32),
                "valids": np.zeros((B,), np.int32),
                "tables": np.full((B, self.max_pages), NULL_BLOCK, np.int32),
                "poison": np.zeros((B,), np.bool_)}

    # ----------------------------------------------------------- public
    def compile_buckets(self):
        """Build and load the kernels, then run the megastep once at every
        bucket width over all-null page tables with zero valid tokens (with
        ``cuda_graphs``, that run is each width's warm-up, and its graph is
        captured): the K/V writes land in the reserved null block and the
        outputs are discarded, so live state is untouched, and serving
        never pays a kernel build or a capture mid-traffic. Idempotent;
        recorded in ``compiled_buckets``, not in ``trace_buckets`` (which
        counts only widths live traffic dispatched). Under a mesh every
        shard writes only its null block. A no-op for the legacy loop, as
        in the reference: its kernels build, and its decode is captured,
        at first use."""
        if not self.use_megastep:
            return
        if self.device.type == "cuda":
            pa.load_kernel()
        for C in self.bucket_set:
            self._dispatch(("mega", C), self._mega, self._null_inputs(C))
            self.compiled_buckets.add(C)
        self.sync()

    def set_token_budget(self, budget: int) -> int:
        """Retune the per-step token budget LIVE.

        The bucket set is fixed at construction (and run once by
        ``compile_buckets``), so the only legal budgets are its members:
        every width the packer can then emit is the smallest bucket >= the
        packed width, which stays inside the original set. The
        stall-free floor (``budget >= max_batch``) still applies, so the
        overload autopilot shrinking toward decode-first can never starve
        an active row. Returns the budget actually installed.
        """
        if self.token_budget is None:
            raise ValueError(
                "set_token_budget requires a budgeted megastep engine "
                "(constructed with token_budget=...)")
        budget = int(budget)
        if budget not in self.bucket_set:
            raise ValueError(
                f"budget {budget} not in the pre-traced bucket set "
                f"{self.bucket_set}: a live retune may only move between "
                "bucket members (anything else would retrace mid-traffic)")
        if budget < self.max_batch:
            raise ValueError(
                f"budget {budget} < max_batch {self.max_batch}: the "
                "decode-first pack needs one token per batch row")
        self.token_budget = budget
        self.first_chunk_cap = min(self.prefill_chunk, budget)
        self.obs.metrics.gauge(f"{self.name}.token_budget").set(budget)
        return budget

    def budget_rungs(self) -> Tuple[int, ...]:
        """The legal live-retune ladder, smallest first: bucket-set members
        that satisfy the stall-free ``>= max_batch`` floor."""
        return tuple(b for b in self.bucket_set if b >= self.max_batch)

    def _sess_track(self, rid: int) -> int:
        """Per-session flight-recorder track (lazily interned; one Perfetto
        row per session, reused across its turns)."""
        tr = self._sess_tracks.get(rid)
        if tr is None:
            grp = ("sessions" if self.name == "engine"
                   else f"{self.name} sessions")
            tr = self._sess_tracks[rid] = self.obs.recorder.track(
                f"session {rid}", group=grp)
        return tr

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               retain: bool = False) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = PagedRequest(rid, np.asarray(prompt, np.int32),
                           max_new_tokens=max_new_tokens, retain=retain,
                           t_enqueue=time.perf_counter())
        req.t_queued = req.t_enqueue
        req.pending = [int(t) for t in req.prompt]
        assert len(req.pending) < self.max_len, "prompt longer than max_len"
        self.reqs[rid] = req
        self._queue.append(req)
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_enq, self._sess_track(rid), rid,
                        len(req.pending))
        return rid

    def extend(self, rid: int, tokens: np.ndarray,
               max_new_tokens: int = 16) -> int:
        """Start a new turn on a retained session: the previous turn's final
        token plus the new prompt tokens are chunk-prefilled into the
        session's pages (their KV lands next to the cached history), then
        generation continues as usual."""
        req = self.reqs[rid]
        assert req.state in (PARKED, SWAPPED), \
            f"extend needs a parked/swapped session, rid {rid} is {req.state}"
        new = [int(t) for t in np.asarray(tokens).reshape(-1)]
        held = (req.num_tokens if req.state != SWAPPED
                else self.swap.store.peek(rid)[2])
        if held + len(new) + 1 > self.max_len:
            raise ValueError(
                f"extend overflows max_len: session rid {rid} holds {held} "
                f"tokens, {len(new)} more won't fit in {self.max_len}")
        req.pending = [req.last_tok] + new
        req.max_new_tokens = max_new_tokens
        req.out_tokens = []
        req.done = False
        req.fresh_turn = False       # cache positions now diverge from prompt
        req.t_enqueue = time.perf_counter()
        req.t_queued = req.t_enqueue
        req.t_last_tok = None        # new turn: TTFT clock restarts
        self._queue.append(req)
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_enq, self._sess_track(rid), rid,
                        len(req.pending))
        return rid

    def fork(self, rid: int) -> int:
        """Clone a parked session copy-on-write: the clone shares every
        resident page until either side appends to the shared tail."""
        req = self.reqs[rid]
        assert req.state == PARKED, \
            f"fork needs a resident parked session, rid {rid} is {req.state}"
        self.swap.touch(rid)        # the shared pages just became load-bearing
        nrid = self._next_rid
        self._next_rid += 1
        clone = PagedRequest(nrid, req.prompt, retain=req.retain,
                             last_tok=req.last_tok, state=PARKED,
                             table=self.cache.fork(req.table))
        self.reqs[nrid] = clone
        self.swap.mark_cold(rid, req.table)
        self.swap.mark_cold(nrid, clone.table)
        return nrid

    # ------------------------------------------------- preemption hooks
    def park(self, rid: int):
        """Preempt an ACTIVE sequence *in place*: its decode slot is
        released but its pages (and any half-consumed pending prefill) stay
        exactly as they are, so ``resume`` continues bit-identically. A
        parked sequence is an eviction candidate — under block pressure it
        may be swapped to host RAM, which changes its block ids but not a
        byte of its state."""
        req = self.reqs[rid]
        assert req.state == ACTIVE, \
            f"park needs an ACTIVE sequence, rid {rid} is {req.state}"
        self.active.pop(rid)
        self.free_slots.append(req.slot)
        req.slot = None
        req.state = PARKED
        self.swap.mark_cold(rid, req.table)
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_park, self._sess_track(rid), rid)

    def resume(self, rid: int):
        """Re-queue a parked/swapped mid-turn sequence for admission; it
        picks up the same turn where ``park`` left it."""
        req = self.reqs[rid]
        assert req.state in (PARKED, SWAPPED), \
            f"resume needs a parked/swapped sequence, rid {rid} is {req.state}"
        assert not req.done, f"rid {rid} has no in-flight turn to resume"
        if not any(r is req for r in self._queue):
            req.t_queued = time.perf_counter()   # new admission-wait episode
            self._queue.append(req)
            rec = self.obs.recorder
            if rec.enabled:
                rec.instant(self._ev_resume, self._sess_track(rid), rid)

    # ------------------------------------------------------ hibernation
    def _on_evicted(self, rid: int):
        """SwapManager evicted this session (explicit hibernate or LRU
        reclaim) — its table is gone from the device either way."""
        req = self.reqs.get(rid)
        if req is not None:
            req.table = None
            req.state = SWAPPED
            rec = self.obs.recorder
            if rec.enabled:
                rec.instant(self._ev_swap_out, self._sess_track(rid), rid)

    def hibernate(self, rid: int):
        """Swap a session's pages to host RAM — O(live pages)."""
        req = self.reqs[rid]
        if req.state == SWAPPED:
            return
        assert req.state in (ACTIVE, PARKED), \
            f"cannot hibernate rid {rid} in state {req.state}"
        if req.state == ACTIVE:
            self.free_slots.append(req.slot)
            self.active.pop(rid)
            req.slot = None
        self.swap.swap_out(rid, req.table)

    def wake(self, rid: int):
        """Bring a hibernated session back to residency (parked, cold)."""
        req = self.reqs[rid]
        if req.state != SWAPPED:
            return
        req.table = self.swap.swap_in(rid)
        req.state = PARKED
        self.swap.mark_cold(rid, req.table)
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_wake, self._sess_track(rid), rid)
        if req.fresh_turn:
            # hibernation freed the session's old blocks (purging their
            # prefix-index entries); the rebound blocks hold the same prompt
            # KV, so re-register them — a later prompt that block-aligns
            # with this session's prefix must still adopt shared blocks
            self.cache.register_prefix(
                req.prompt, req.table,
                min(req.num_tokens, len(req.prompt)))

    def release(self, rid: int):
        """Drop a session entirely, in any state (frees its decode slot,
        queue entry, device blocks, or host pages)."""
        req = self.reqs.pop(rid)
        self._queue = [r for r in self._queue if r is not req]
        if req.state == ACTIVE:
            self.active.pop(rid, None)
            self.free_slots.append(req.slot)
            req.slot = None
        self.swap.touch(rid)
        if req.state == SWAPPED:
            self.swap.discard(rid)
        elif req.table is not None:
            self.cache.free_table(req.table)
            req.table = None
        req.state = FREED

    def abort_turn(self, rid: int):
        """Cancel an in-flight turn (zombie reap): un-written prompt tokens
        and generation are dropped *between steps*, so batchmates never see
        a mid-step perturbation. A retained session survives parked (its
        next ``extend`` continues from whatever was written); anything else
        is freed."""
        req = self.reqs.get(rid)
        if req is None:
            return
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_abort, self._sess_track(rid), rid)
        self._queue = [r for r in self._queue if r is not req]
        if req.pending:
            # keep the "last_tok = next input token" invariant: everything
            # before pending[0] is in the cache, pending[0] is not
            req.last_tok = req.pending[0]
            req.pending = []
        req.done = True
        if req.state == ACTIVE:
            self.active.pop(rid, None)
            self.free_slots.append(req.slot)
            req.slot = None
            if req.retain:
                req.state = PARKED
                self.swap.mark_cold(rid, req.table)
            else:
                self.cache.free_table(req.table)
                req.table = None
                req.state = FREED
                self.reqs.pop(rid, None)
        elif req.state == QUEUED:            # fresh, never admitted
            req.state = FREED
            self.reqs.pop(rid, None)
        elif req.state in (PARKED, SWAPPED) and not req.retain:
            self.release(rid)                # a parked one-shot: nothing left
        # retained PARKED / SWAPPED sessions just lose the un-admitted turn

    # ------------------------------------------------------------ admit
    def can_admit(self, n_prompt_tokens: int) -> bool:
        """Would a fresh prompt of this length get a slot and first-chunk
        blocks right now (counting cold pages the swap tier could reclaim)?
        The fused dispatcher gates MLFQ dequeue on this, so turns are only
        pulled when the engine can actually take them. "First chunk" is
        budget-aware: with a token budget smaller than ``prefill_chunk``
        the first dispatch can write at most ``token_budget`` prompt
        tokens, so that is all admission reserves for."""
        if len(self.free_slots) <= len(self._queue):
            return False
        need = self.cache.pages_for(min(n_prompt_tokens,
                                        self.first_chunk_cap))
        return need <= self.cache.allocator.num_free + self.swap.cold_pages()

    def _ensure_blocks(self, n: int):
        if self.cache.allocator.num_free < n:
            self.swap.reclaim(n)

    def _ensure_capacity(self, req: PagedRequest, n_tokens: int):
        """ensure_capacity with demand paging: reclaim cold sessions when
        the pool can't grow this sequence (the +1 covers a possible
        copy-on-write of a shared tail block)."""
        try:
            self.cache.ensure_capacity(req.table, n_tokens)
        except OutOfBlocksError:
            need = self.cache.pages_for(n_tokens) - req.table.num_pages + 1
            self.swap.reclaim(max(need, 1))
            self.cache.ensure_capacity(req.table, n_tokens)

    def _admit(self):
        while self._queue and self.free_slots:
            req = self._queue[0]
            try:
                if req.state == QUEUED:
                    self._admit_fresh(req)
                else:
                    self._admit_resume(req)
            except OutOfBlocksError:
                break               # head-of-line blocks until pages free up
            except SwapIOError as e:
                # a corrupted / unreadable swap payload kills only THIS
                # session's admission: the payload is junk, so drop the
                # session (its owner restores it from the journal) and let
                # the queue keep moving — never head-of-line-block on it
                self._c_swap_fail.inc()
                self.last_failures.append((req.rid, e))
                self._queue.pop(0)
                self.swap.discard(req.rid)
                req.state = FREED
                req.done = True
                self.reqs.pop(req.rid, None)
                continue
            self._queue.pop(0)
            req.slot = self.free_slots.pop(0)
            req.state = ACTIVE
            self.active[req.rid] = req
            self.swap.touch(req.rid)
            rec = self.obs.recorder
            if rec.enabled:
                tr = self._sess_track(req.rid)
                # the queued span covers this admission-wait episode
                # (enqueue/extend/resume -> slot granted)
                rec.complete(self._ev_queued, tr, req.t_queued, req.rid)
                rec.instant(self._ev_admit, tr, req.rid)

    def _admit_fresh(self, req: PagedRequest):
        """Admission costs blocks for the *first chunk only* (minus any
        indexed prompt prefix adopted from another session); later chunks
        allocate as they land."""
        plen = len(req.prompt)
        toks = [int(t) for t in req.prompt]
        shared = self.cache.adopt_prefix(toks)
        n_shared = len(shared) * self.cache.block_size
        first = min(plen - n_shared, self.first_chunk_cap)
        pt = PageTable(self.cache.block_size, shared, n_shared)
        try:
            need = self.cache.pages_for(n_shared + first) - len(shared)
            self._ensure_blocks(need)
            self.cache.ensure_capacity(pt, n_shared + first)
        except OutOfBlocksError:
            for bid in pt.blocks:
                self.cache._release_block(bid)
            raise
        req.table = pt
        req.pending = toks[n_shared:]

    def _admit_resume(self, req: PagedRequest):
        if req.state == SWAPPED:
            self.wake(req.rid)
        self.swap.touch(req.rid)

    # ------------------------------------------------------------- step
    def step(self) -> List[PagedRequest]:
        """Advance the batch one iteration: every prefilling sequence takes
        one prompt chunk, every decoding sequence one token. Returns
        requests whose turn finished this step; per-rid service counts (in
        tokens) land in ``last_serviced``.

        With ``megastep`` (the default) the whole iteration is ONE
        ``mixed_step_paged`` call; the legacy loop (one call per
        prefilling sequence plus a decode call) is kept as the benchmark
        baseline."""
        self.last_serviced = {}
        self.last_failures = []
        self._seq += 1
        rec = self.obs.recorder
        tracing = rec.enabled and self.use_megastep
        ta = time.perf_counter() if tracing else 0.0
        self._admit()                 # may append swap-IO casualties
        if not self.active:
            if tracing:
                rec.complete(self._ev_phases[0], self._tr_step, ta,
                             self._seq)
            return []
        t0 = time.perf_counter()
        before = self._c_jit.value
        if self.use_megastep:
            fins = self._step_megastep(t0, ta)
        else:
            fins = self._step_legacy(t0)
        if self._c_jit.value != before:     # a work-doing iteration
            self.h_step.observe(time.perf_counter() - t0)
        return fins

    def _grown(self, req: PagedRequest, n_tokens: int) -> bool:
        """Per-sequence OOM isolation: if the pool cannot grow this
        sequence even after reclaim, abort IT (retained -> parked,
        turn lost) and let its batchmates proceed untouched. A swap-IO
        failure during reclaim is confined the same way: the growing
        sequence's turn dies typed, its batchmates continue."""
        try:
            self._ensure_capacity(req, n_tokens)
            return True
        except OutOfBlocksError as e:
            self._c_kv_aborts.inc()
            self.last_failures.append((req.rid, KVPressureError(str(e))))
            self.abort_turn(req.rid)
            return False
        except SwapIOError as e:
            self._c_swap_fail.inc()
            self.last_failures.append((req.rid, e))
            self.abort_turn(req.rid)
            return False

    def _fail_poisoned(self, req: PagedRequest):
        """A row's logits went non-finite: fail exactly this row's turn
        (typed ``PoisonedRowError``), leaving batchmates untouched. A
        retained session parks as usual — the poison lived in the logits,
        not its cache pages."""
        self._poison_rids.discard(req.rid)
        self._c_poisoned.inc()
        self.last_serviced.pop(req.rid, None)
        self.last_failures.append((req.rid, PoisonedRowError(
            f"rid {req.rid}: non-finite logits row — turn aborted, "
            "batchmates unaffected")))
        self.abort_turn(req.rid)

    # --------------------------------------------- chaos / recovery API
    def inject_poison(self, rid: int):
        """Arm one row for logit poisoning (NaN) on its next dispatch —
        the seeded fault layer's handle for exercising the in-step
        finiteness sentinel end-to-end. Consumed when the poison lands."""
        if rid in self.reqs:
            self._poison_rids.add(rid)

    def export_session(self, rid: int) -> Optional[Dict]:
        """Snapshot a session's recoverable state (exact KV page bytes +
        turn metadata) for the write-ahead session journal. Only coherent
        between turns (parked/swapped); an ACTIVE mid-turn session returns
        None — its in-flight turn is the journal's replay unit, not a
        snapshot target."""
        req = self.reqs.get(rid)
        if req is None or req.state == ACTIVE or not req.done:
            return None
        if req.state == SWAPPED:
            payload = self.swap.store.peek(rid)
            k_pages, v_pages, n = payload
        elif req.table is not None:
            k_pages, v_pages = self.cache.gather(req.table)
            n = req.table.num_tokens
        else:
            return None
        return {"k_pages": np.asarray(k_pages), "v_pages": np.asarray(v_pages),
                "num_tokens": int(n), "last_tok": int(req.last_tok),
                "out_tokens": [int(t) for t in req.out_tokens],
                "prompt": np.asarray(req.prompt, np.int32)}

    def restore_session(self, payload: Dict) -> int:
        """Rebuild a journaled session in THIS engine: the payload's pages
        enter through the swap store (checksummed), so the session comes
        back SWAPPED and its next turn wakes it through the ordinary
        demand-paging path — the same bit-exact route hibernation takes."""
        return self.import_live(payload)

    def export_live(self, rid: int, pages: Optional[tuple] = None
                    ) -> Optional[Dict]:
        """Mid-turn-capable superset of ``export_session``: also carries
        the in-flight turn state (pending inputs, turn budget, done flag)
        so a fleet can move a session whose turn is still decoding.
        The caller must ``park`` an ACTIVE session first — the page bytes
        are only coherent between dispatches. ``pages`` optionally
        overrides the full gather with pre-assembled ``(k, v, n)`` host
        pages (fluid migration streams most of them ahead of time)."""
        req = self.reqs.get(rid)
        if req is None or req.state == ACTIVE:
            return None
        if pages is not None:
            k_pages, v_pages, n = pages
        elif req.state == SWAPPED:
            k_pages, v_pages, n = self.swap.store.peek(rid)
        elif req.table is not None:
            k_pages, v_pages = self.cache.gather(req.table)
            n = req.table.num_tokens
        else:
            return None
        return {"k_pages": np.asarray(k_pages),
                "v_pages": np.asarray(v_pages),
                "num_tokens": int(n), "last_tok": int(req.last_tok),
                "out_tokens": [int(t) for t in req.out_tokens],
                "prompt": np.asarray(req.prompt, np.int32),
                "pending": [int(t) for t in req.pending],
                "max_new_tokens": int(req.max_new_tokens),
                "done": bool(req.done),
                "fresh_turn": bool(req.fresh_turn),
                "retain": bool(req.retain)}

    def import_live(self, payload: Dict) -> int:
        """Adopt an exported session (journal restore or cross-engine
        migration). Pages enter through the checksummed swap store, so the
        session lands SWAPPED; a not-done payload is mid-turn and resumes
        decoding bit-exactly once ``resume``d. Journal payloads carry no
        turn state and default to the between-turns shape restore_session
        always produced."""
        rid = self._next_rid
        self._next_rid += 1
        req = PagedRequest(rid, np.asarray(payload["prompt"], np.int32),
                           max_new_tokens=int(
                               payload.get("max_new_tokens", 16)),
                           retain=bool(payload.get("retain", True)),
                           state=SWAPPED,
                           done=bool(payload.get("done", True)),
                           fresh_turn=bool(payload.get("fresh_turn", False)),
                           last_tok=int(payload["last_tok"]))
        req.out_tokens = [int(t) for t in payload.get("out_tokens", ())]
        req.pending = [int(t) for t in payload.get("pending", ())]
        req.t_enqueue = req.t_queued = time.perf_counter()
        self.reqs[rid] = req
        self.swap.adopt(rid, np.asarray(payload["k_pages"]),
                        np.asarray(payload["v_pages"]),
                        int(payload["num_tokens"]))
        return rid

    def _finish_token(self, req: PagedRequest, tok: int,
                      finished: List[PagedRequest]):
        """Record a sampled token and retire the turn if it is complete."""
        now = time.perf_counter()
        if req.t_last_tok is None:
            self.h_ttft.observe(now - req.t_enqueue)
        else:
            self.h_itl.observe(now - req.t_last_tok)
        req.t_last_tok = now
        req.out_tokens.append(tok)
        req.last_tok = tok
        rec = self.obs.recorder
        if rec.enabled:
            rec.instant(self._ev_token, self._sess_track(req.rid),
                        req.rid, len(req.out_tokens))
        if (len(req.out_tokens) >= req.max_new_tokens
                or req.num_tokens >= self.max_len - 1):
            finished.append(req)
            if rec.enabled:
                tr = self._sess_track(req.rid)
                # the turn span covers enqueue -> last token, the whole
                # session lifecycle visible as one Perfetto slice
                rec.complete(self._ev_turn, tr, req.t_enqueue, req.rid,
                             len(req.out_tokens))
                rec.instant(self._ev_finish, tr, req.rid,
                            len(req.out_tokens))
            self._retire(req)

    def _bucket_for(self, width: int) -> int:
        """Smallest trace bucket >= the packed max row width."""
        for b in self.bucket_set:
            if b >= width:
                return b
        return self.bucket_set[-1]

    def _pack_rows(self) -> List[tuple]:
        """Assemble one iteration's (req, T) rows.

        Without a budget this is the fixed-chunk pack: every
        prefilling row takes ``min(prefill_chunk, pending)``.

        With a ``token_budget`` the pack is **decode-first** (DESIGN.md
        §11): decoding rows are packed first at one token each — decode is
        never stalled or rationed — then the remaining budget is split
        evenly across prefilling rows (ceil-divided over the rows still
        unpacked, so a lone prompt takes everything and k prompts take
        ~1/k each). Because ``budget >= max_batch``, the remainder always
        covers at least one token per prefilling row: no active row is
        ever skipped, the total never exceeds the budget."""
        rows: List[tuple] = []
        budget = self.token_budget
        if budget is None:
            for req in list(self.active.values()):
                if req.prefilling:
                    T = min(self.prefill_chunk, len(req.pending))
                    if self._grown(req, req.num_tokens + T):
                        rows.append((req, T))
                elif self._grown(req, req.num_tokens + 1):
                    rows.append((req, 1))
            return rows
        prefilling: List[PagedRequest] = []
        remaining = budget
        for req in list(self.active.values()):
            if req.prefilling:
                prefilling.append(req)
            elif self._grown(req, req.num_tokens + 1):
                rows.append((req, 1))
                remaining -= 1
        for i, req in enumerate(prefilling):
            share = -(-remaining // (len(prefilling) - i))  # ceil-split
            T = min(len(req.pending), remaining, max(share, 1))
            if T <= 0:
                continue                     # budget < max_batch impossible;
            fallback = min(T, self.first_chunk_cap)       # defensive only
            if T > fallback:
                # admission only reserved first_chunk_cap blocks; a wider
                # budget share must find its extra blocks NOW or degrade
                # to chunk pace — never abort a turn for wanting to go
                # faster than the reservation
                try:
                    self._ensure_capacity(req, req.num_tokens + T)
                except OutOfBlocksError:
                    T = fallback
            if self._grown(req, req.num_tokens + T):
                rows.append((req, T))
                remaining -= T
        return rows

    def _step_megastep(self, t0: float, ta: float) -> List[PagedRequest]:
        """The fused iteration: pack one (max_batch, C) token matrix
        (decode-first under a token budget — see ``_pack_rows``), make ONE
        ``mixed_step_paged`` call over the union (K/V scatter, paged
        attention, greedy sampling all inside), and read back a single
        (max_batch,) int32 token vector. C is the packed maximum row width
        rounded up to the bounded ``bucket_set``, so decode-only iterations
        use the C == 1 bucket (never paying chunk-width FLOPs) and the
        number of distinct widths stays <= len(bucket_set).

        ``t0`` anchors the step's flight-recorder span: host wall clock
        around the one dispatch (pack -> dispatch -> int32 readback),
        annotated with C / rows / tokens — all host-available already, so
        the one-dispatch and int32-return contracts are untouched by
        tracing. With the recorder on, the host phases (``PHASES``: admit
        from ``ta`` to ``t0``, then pack, stage, launch, readback,
        bookkeep) are one span each; with it off no clock is read for
        them."""
        rec = self.obs.recorder
        tracing = rec.enabled
        finished: List[PagedRequest] = []
        rows = self._pack_rows()             # (req, T) surviving growth
        if not rows:
            if tracing:
                tp = time.perf_counter()
                for ev, a, b in ((self._ev_phases[0], ta, t0),
                                 (self._ev_phases[1], t0, tp)):
                    rec.interval(ev, self._tr_step, a, b, self._seq)
            return finished
        C = self._bucket_for(max(T for _, T in rows)) \
            if self.token_budget else \
            (self.prefill_chunk if any(r.prefilling for r, _ in rows) else 1)
        self.trace_buckets.add(C)
        step_real = sum(T for _, T in rows)
        self.tokens_real += step_real
        self.tokens_dispatched += self.max_batch * C
        self._c_dense_slots.inc(self.flat_width[C])
        if self.flat_width[C] < self.max_batch * C:
            self._c_flat_steps.inc()
        ins = self._null_inputs(C)
        for req, T in rows:
            s = req.slot
            if req.prefilling:
                ins["toks"][s, :T] = req.pending[:T]
            else:
                ins["toks"][s, 0] = req.last_tok
            ins["lens"][s] = req.num_tokens
            ins["valids"][s] = T
            ins["tables"][s] = req.table.padded(self.max_pages)
            if req.rid in self._poison_rids:
                ins["poison"][s] = True
        ts = time.perf_counter() if tracing else 0.0
        launch = self._stage(("mega", C), self._mega, ins)
        tl = time.perf_counter() if tracing else 0.0
        next_tok = launch()
        if self.graphs is not None:
            self.compiled_buckets.add(C)
        self.jit_dispatches += 1
        self.steps_dispatched += 1
        if any(not r.prefilling for r, _ in rows):
            self.decode_steps += 1
        tr = time.perf_counter() if tracing else 0.0
        out = next_tok.cpu().numpy()         # (max_batch,) int32 — the only
        tb = time.perf_counter() if tracing else 0.0   # per-step D2H copy
        for req, T in rows:
            was_prefilling = req.prefilling
            req.table.num_tokens += T
            if tracing:
                # per-engine-row occupancy span + per-session chunk span,
                # both covering this step's host wall window
                rec.complete(self._ev_row, self._tr_rows[req.slot], t0,
                             req.rid, T, 1.0 if was_prefilling else 0.0)
                if was_prefilling:
                    rec.complete(self._ev_prefill,
                                 self._sess_track(req.rid), t0,
                                 req.rid, T, req.num_tokens)
            if int(out[req.slot]) < 0:
                # the in-step finiteness sentinel: this row's logits went
                # NaN/Inf (injected or genuine) — fail exactly this turn.
                # Batchmates read their own slots, which a poisoned row
                # cannot perturb (attention is per-row over its own pages
                # and poison lands after the K/V writes).
                if was_prefilling:
                    del req.pending[:T]
                self._fail_poisoned(req)
                continue
            if was_prefilling:
                del req.pending[:T]
                if req.fresh_turn:
                    # only the original prompt's write window may feed the
                    # dedup index — extend turns write non-prompt tokens
                    self.cache.register_prefix(req.prompt, req.table,
                                               req.num_tokens)
                self.last_serviced[req.rid] = T
                if req.pending:
                    continue                 # more chunks next step
            else:
                self.last_serviced[req.rid] = \
                    self.last_serviced.get(req.rid, 0) + 1
            self._finish_token(req, int(out[req.slot]), finished)
        if tracing:
            te = time.perf_counter()
            seq, n = self._seq, len(rows)
            rec.interval(self._ev_step, self._tr_step, t0, te, seq, C, n,
                         step_real)
            for ev, a, b in zip(self._ev_phases, (ta, t0, ts, tl, tr, tb),
                                (t0, ts, tl, tr, tb, te)):
                rec.interval(ev, self._tr_step, a, b, seq, C, n)
            if self.tp > 1:
                # what this step's reductions moved, per shard: one
                # (flat_width, d) attention partial per layer
                itemsize = torch_dtype(self.cfg.compute_dtype).itemsize
                psum_bytes = (self.cfg.n_layers * self.flat_width[C]
                              * self.cfg.d_model * itemsize)
                rec.instant(self._ev_psum, self._tr_coll, self.tp,
                            self.cfg.n_layers, psum_bytes,
                            self.max_batch * C)
        return finished

    def _step_legacy(self, t0: float = 0.0) -> List[PagedRequest]:
        """The legacy iteration: one ``prefill_chunk_paged`` call per
        prefilling sequence, then one batched ``decode_step_paged`` call —
        1 + n_prefilling calls per step, the full (max_batch, vocab) float32
        logits crossing to the host and argmaxed there."""
        finished: List[PagedRequest] = []
        decoding = [r for r in self.active.values() if not r.prefilling]
        prefilling = [r for r in self.active.values() if r.prefilling]
        dispatches_before = self.jit_dispatches
        tokens_before = self.tokens_real
        rec = self.obs.recorder

        # ---- chunked prefill: one block of prompt per sequence per step
        for req in prefilling:
            T = min(self.prefill_chunk, len(req.pending))
            n = req.num_tokens
            if not self._grown(req, n + T):
                continue
            C = self.prefill_chunk
            ins = {"toks": np.zeros((1, C), np.int32),
                   "cache_len": np.array([n], np.int32),
                   "valid": np.array([T], np.int32),
                   "table": np.asarray(req.table.padded(self.max_pages),
                                       np.int32)}
            ins["toks"][0, :T] = req.pending[:T]
            tc0 = time.perf_counter() if rec.enabled else 0.0
            logits = self._dispatch(("chunk", C), self._chunk, ins)
            self.jit_dispatches += 1
            self.tokens_real += T
            self.tokens_dispatched += self.prefill_chunk
            req.table.num_tokens = n + T
            del req.pending[:T]
            if rec.enabled:
                rec.complete(self._ev_prefill, self._sess_track(req.rid),
                             tc0, req.rid, T, req.num_tokens)
            if req.fresh_turn:
                # only the original prompt's write window may feed the
                # dedup index — extend turns write non-prompt tokens
                self.cache.register_prefix(req.prompt, req.table,
                                           req.num_tokens)
            self.last_serviced[req.rid] = T
            if not req.pending:
                row = logits[0, T - 1].cpu().numpy()
                if req.rid in self._poison_rids or not np.isfinite(row).all():
                    self._fail_poisoned(req)
                else:
                    self._finish_token(req, int(row.argmax()), finished)

        # ---- decode: one token for every sequence past prefill
        decoding = [r for r in decoding
                    if self._grown(r, r.num_tokens + 1)]
        if decoding:
            B = self.max_batch
            ins = {"toks": np.zeros((B, 1), np.int32),
                   "lens": np.zeros((B,), np.int32),
                   "tables": np.full((B, self.max_pages), NULL_BLOCK,
                                     np.int32)}
            for req in decoding:
                ins["lens"][req.slot] = req.num_tokens
                ins["tables"][req.slot] = req.table.padded(self.max_pages)
                ins["toks"][req.slot, 0] = req.last_tok
            logits = self._dispatch("decode", self._decode, ins)
            self.jit_dispatches += 1
            self.decode_steps += 1
            self.tokens_real += len(decoding)
            self.tokens_dispatched += self.max_batch
            rows_np = logits[:, 0].cpu().numpy()     # (max_batch, vocab) f32
            out = rows_np.argmax(axis=-1)
            row_ok = np.isfinite(rows_np).all(axis=-1)
            for req in decoding:
                req.table.num_tokens += 1
                if req.rid in self._poison_rids or not row_ok[req.slot]:
                    self._fail_poisoned(req)
                    continue
                self.last_serviced[req.rid] = \
                    self.last_serviced.get(req.rid, 0) + 1
                self._finish_token(req, int(out[req.slot]), finished)
        dispatched = self.jit_dispatches - dispatches_before
        if dispatched:
            self.steps_dispatched += 1
            if rec.enabled:
                rec.complete(self._ev_legacy, self._tr_step, t0, dispatched,
                             self.tokens_real - tokens_before)
        return finished

    def _retire(self, req: PagedRequest):
        """Turn complete: park a retained session, free everything else."""
        req.done = True
        self.free_slots.append(req.slot)
        req.slot = None
        del self.active[req.rid]
        if req.retain:
            req.state = PARKED
            self.swap.mark_cold(req.rid, req.table)
        else:
            self.cache.free_table(req.table)
            req.table = None
            req.state = FREED
            self.reqs.pop(req.rid, None)

    def run_to_completion(self, max_steps: int = 512) -> List[PagedRequest]:
        done: List[PagedRequest] = []
        for _ in range(max_steps):
            done += self.step()
            if not self.active and not self._queue:
                break
        return done

    # ------------------------------------------------------------ stats
    # The historical counter attributes are registry-backed properties:
    # every read and write goes straight to the unified metrics registry
    # (obs.metrics), so BENCH jsons, step_stats() and the registry can
    # never disagree. Setters exist so benchmarks can zero a measurement
    # window (and keep `+= 1` working on the hot path).
    @property
    def jit_dispatches(self) -> int:
        return int(self._c_jit.value)

    @jit_dispatches.setter
    def jit_dispatches(self, v: int):
        self._c_jit.set(v)

    @property
    def steps_dispatched(self) -> int:
        return int(self._c_steps.value)

    @steps_dispatched.setter
    def steps_dispatched(self, v: int):
        self._c_steps.set(v)

    @property
    def decode_steps(self) -> int:
        return int(self._c_decode_steps.value)

    @decode_steps.setter
    def decode_steps(self, v: int):
        self._c_decode_steps.set(v)

    @property
    def tokens_real(self) -> int:
        return int(self._c_tokens_real.value)

    @tokens_real.setter
    def tokens_real(self, v: int):
        self._c_tokens_real.set(v)

    @property
    def tokens_dispatched(self) -> int:
        return int(self._c_tokens_disp.value)

    @tokens_dispatched.setter
    def tokens_dispatched(self, v: int):
        self._c_tokens_disp.set(v)

    @property
    def ttft_s(self) -> List[float]:
        """Bounded TTFT samples (the histogram's reservoir) — kept as a
        list-shaped view for tests/tools; the distribution itself lives in
        the registry histogram ``engine.ttft_s``."""
        return self.h_ttft.samples

    @property
    def itl_s(self) -> List[float]:
        return self.h_itl.samples

    @property
    def jit_dispatches_per_step(self) -> float:
        """Jitted model calls per work-doing iteration — 1.0 under the
        megastep, 1 + mean(n_prefilling) under the legacy loop."""
        return self.jit_dispatches / max(self.steps_dispatched, 1)

    @property
    def padded_token_fraction(self) -> float:
        """Share of dispatched token slots that carried padding instead of
        real work: 1 - real / (rows x width summed over dispatches). This
        is the FLOP overhead the budget packer's right-sized buckets exist
        to shrink (a fixed chunk pays it on every decode row whenever any
        batchmate is prefilling)."""
        if not self.tokens_dispatched:
            return 0.0
        return 1.0 - self.tokens_real / self.tokens_dispatched

    def step_stats(self) -> Dict[str, float]:
        """Scheduling-side counters for benchmarks / the CI smoke gate —
        every number read from (or derived over) the unified registry."""
        return {
            "jit_dispatches": self.jit_dispatches,
            "steps_dispatched": self.steps_dispatched,
            "jit_dispatches_per_step": self.jit_dispatches_per_step,
            "tokens_real": self.tokens_real,
            "tokens_dispatched": self.tokens_dispatched,
            "padded_token_fraction": self.padded_token_fraction,
            "flat_steps": int(self._c_flat_steps.value),
            "dense_slots": int(self._c_dense_slots.value),
            "trace_buckets": sorted(self.trace_buckets),
            "bucket_set": list(self.bucket_set),
            "token_budget": self.token_budget,
            "tp": self.tp,
            # the megastep's per-step device->host traffic: one int32 per
            # batch row (the sampled ids) — mesh or not, the same bytes
            "host_transfer_bytes_per_step": self.max_batch * 4,
            "ttft_p95_s": self.h_ttft.quantile(0.95),
            "itl_p95_s": self.h_itl.quantile(0.95),
            "step_p95_s": self.h_step.quantile(0.95),
            "trace_events_dropped": self.obs.recorder.dropped,
        }

    def graph_stats(self) -> Dict:
        """The compiled dispatch: ``cuda_graphs``, and on the graph route
        the captured steps, how many calls captured (each key's first)
        and replayed, the capture seconds and each key's graph-pool bytes
        (``serving.graphs.StepGraphs.stats``)."""
        out = {"cuda_graphs": self.cuda_graphs}
        if self.graphs is not None:
            out.update(self.graphs.stats())
        return out

    def sync(self):
        """Block until every queued pool update has landed — timed regions
        end here so asynchronous launches cannot flatter wall-clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def kv_stats(self) -> Dict[str, int]:
        alloc = self.cache.allocator
        live = sum(r.num_tokens for r in self.reqs.values()
                   if r.table is not None)
        stats = {
            "block_size": self.cache.block_size,
            "blocks_total": self.cache.num_blocks - 1,
            "blocks_in_use": alloc.num_used,
            "kv_bytes_total": self.cache.bytes_total,
            "kv_bytes_in_use": self.cache.bytes_in_use,
            "live_context_tokens": live,
            **self.cache.prefix_stats(),
            **self.swap.stats(),
        }
        # publish into the unified registry so metrics dumps / BENCH jsons
        # and this dict are one derivation, never two; named fleet members
        # publish under kv.<name>.* so engines sharing a registry don't
        # clobber each other's gauges
        m = self.obs.metrics
        prefix = "kv." if self.name == "engine" else f"kv.{self.name}."
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                m.gauge(prefix + k).set(float(v))
        return stats
