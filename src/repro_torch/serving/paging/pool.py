"""PagedKVCache: the pooled physical KV store + page-table bookkeeping.

One ``(L, num_blocks, blk, hkv, hd)`` tensor per K and V backs every
sequence; block ids are shared across layers, so one page table per
sequence maps its positions for the whole stack. The BlockAllocator
decides *which* block; this class moves the bytes: copy-on-write
duplication and the host<->device page transfers the swap tier is built on.

Under a tensor-parallel mesh (``mesh=``, DESIGN.md §13) each shard holds
its own ``(L, num_blocks, blk, hkv/tp, hd)`` pools on its device: the
KV-head slice ``[i*hkv/tp, (i+1)*hkv/tp)``. Block ids, page tables and the
prefix index are shard-invariant, and every byte-moving method acts on
every shard. Host pages stay full-hkv (the shards' slices concatenated in
kv-head order), so hibernation, the journal, the disk tier and migration
do not see the mesh's shape.

The pools are device tensors updated in place (``index_put_``) where the
reference donates and replaces its buffers; a float8_e4m3fn pool (an fp8
KV cache) moves its pages as uint8 bits. Host pages keep the reference's
``(L, pages, blk, hkv, hd)`` layout; a bf16 pool's pages travel as their
raw bits in ``np.uint16``, an fp8 pool's in ``np.uint8``. Written pages
are read by the pool's own dtype (``weights.host_as``): bit patterns as
bits, ml_dtypes arrays as theirs, other values cast as the reference
casts.

A prompt-prefix index dedups full, block-aligned prompt prefixes across
sessions: a new session whose prompt starts with an indexed prefix adopts
those blocks through the refcount/COW machinery instead of recomputing
them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.serving.paging.allocator import (NULL_BLOCK, BlockAllocator,
                                                  PageTable)
from repro_torch.device import bits
from repro_torch.weights import host_as, torch_to_numpy


def _pow2_pad(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PagedKVCache:
    """Pooled paged KV storage for the decoder-only GQA family."""

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        devices = mesh.devices if mesh is not None else (device,)
        tp = len(devices)
        lcfg = cfg.replace(n_kv_heads=cfg.n_kv_heads // tp,
                           head_dim=cfg.resolved_head_dim)
        # one {"k", "v"} per shard, shard i holding kv heads
        # [i*hkv/tp, (i+1)*hkv/tp)
        self.shards: List[Dict[str, torch.Tensor]] = [
            tr.init_paged_pools(lcfg, num_blocks, block_size, dev)
            for dev in devices]
        self.device = self.shards[0]["k"].device
        self.allocator = BlockAllocator(num_blocks)
        L, _, blk, hkv, hd = self.shards[0]["k"].shape
        self.block_bytes = (2 * L * blk * hkv * tp * hd
                            * self.shards[0]["k"].element_size())
        # ---- prompt-prefix dedup index -----------------------------------
        # key = the raw bytes of a block-aligned prompt prefix; value = the
        # block id holding that prefix's *last* block. Entries are dropped
        # the moment their block's refcount reaches zero, so a hit is always
        # a live block.
        self._prefix_index: Dict[bytes, int] = {}
        self._prefix_of: Dict[int, bytes] = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prompt_blocks_shared = 0
        self.prompt_blocks_fresh = 0

    # ------------------------------------------------------------- pools
    def pools(self) -> List[Dict[str, torch.Tensor]]:
        """Each shard's pool tensors, which the megastep writes in place
        (one entry without a mesh)."""
        return self.shards

    def set_pools(self, pools: List[Dict[str, torch.Tensor]]):
        """Rebind every shard's K and V pools to ``pools``: the list
        ``pools()`` returns, one {"k", "v"} per shard, each of its shard's
        shape, dtype and device. The reference's engine hands back the
        buffers its donated steps return through this; the port's steps
        write the pools in place, so its engine has no need to."""
        if len(pools) != len(self.shards):
            raise ValueError(f"{len(pools)} pools for {len(self.shards)} "
                             "shards")
        for old, new in zip(self.shards, pools):
            for name in ("k", "v"):
                a, b = old[name], new[name]
                if (a.shape, a.dtype, a.device) != (b.shape, b.dtype,
                                                    b.device):
                    raise ValueError(
                        f"pool {name}: {tuple(b.shape)} {b.dtype} on "
                        f"{b.device}, not {tuple(a.shape)} {a.dtype} on "
                        f"{a.device}")
        self.shards = [{"k": p["k"], "v": p["v"]} for p in pools]

    def full_pools(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole K and V pools, (L, num_blocks, blk, hkv, hd): without
        a mesh the live tensors themselves, under one a copy that joins the
        shards' slices in kv-head order on the first shard's device."""
        if len(self.shards) == 1:
            return self.shards[0]["k"], self.shards[0]["v"]
        dtype = self.shards[0]["k"].dtype
        return tuple(torch.cat([bits(s[n]).to(self.device)
                                for s in self.shards], dim=3).view(dtype)
                     for n in ("k", "v"))

    # ------------------------------------------------------------- sizes
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def bytes_in_use(self) -> int:
        return self.allocator.num_used * self.block_bytes

    @property
    def bytes_total(self) -> int:
        return (self.num_blocks - 1) * self.block_bytes

    # ----------------------------------------------------------- tables
    def alloc_table(self, n_tokens: int) -> PageTable:
        blocks = self.allocator.alloc_many(self.pages_for(n_tokens))
        return PageTable(self.block_size, blocks, 0)

    def free_table(self, pt: PageTable):
        for bid in pt.blocks:
            self._release_block(bid)
        pt.blocks = []
        pt.num_tokens = 0

    def fork(self, pt: PageTable) -> PageTable:
        """Share every block with a new sequence. O(pages) bookkeeping,
        zero bytes copied — divergent writes copy-on-write in
        ``ensure_capacity``."""
        for bid in pt.blocks:
            self.allocator.share(bid)
        return PageTable(pt.block_size, list(pt.blocks), pt.num_tokens)

    def _release_block(self, bid: int):
        """Drop one reference; purge the prefix index if the block died."""
        if self.allocator.release(bid):
            key = self._prefix_of.pop(bid, None)
            if key is not None:
                self._prefix_index.pop(key, None)

    # -------------------------------------------------- prefix dedup
    def adopt_prefix(self, tokens) -> List[int]:
        """Longest indexed block-aligned *strict* prefix of ``tokens``:
        returns the block ids (refcounts already bumped). Capped at
        ``len(tokens) - 1`` positions — the final prompt token is always
        recomputed, because its logits seed generation."""
        self.prefix_lookups += 1
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        shared: List[int] = []
        k = 1
        while k * self.block_size <= len(toks) - 1:
            bid = self._prefix_index.get(toks[: k * self.block_size].tobytes())
            if bid is None:
                break
            self.allocator.share(bid)
            shared.append(bid)
            k += 1
        eligible = max(0, (len(toks) - 1) // self.block_size)
        self.prompt_blocks_shared += len(shared)
        self.prompt_blocks_fresh += eligible - len(shared)
        if shared:
            self.prefix_hits += 1
        return shared

    def prefix_match_blocks(self, tokens) -> int:
        """Side-effect-free probe: how many block-aligned strict-prefix
        blocks of ``tokens`` this pool already indexes."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        k = 0
        while (k + 1) * self.block_size <= len(toks) - 1:
            key = toks[: (k + 1) * self.block_size].tobytes()
            if key not in self._prefix_index:
                break
            k += 1
        return k

    def register_prefix(self, tokens, pt: PageTable, upto_tokens: int):
        """Index ``pt``'s full blocks whose contents are exactly the first
        ``upto_tokens`` positions of ``tokens``. Idempotent; first writer
        wins."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        n = min(int(upto_tokens), len(toks))
        for k in range(1, n // self.block_size + 1):
            bid = pt.blocks[k - 1]
            if bid in self._prefix_of:
                continue
            key = toks[: k * self.block_size].tobytes()
            if key not in self._prefix_index:
                self._prefix_index[key] = bid
                self._prefix_of[bid] = key

    def prefix_stats(self) -> Dict[str, float]:
        shared, fresh = self.prompt_blocks_shared, self.prompt_blocks_fresh
        return {
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hits / max(1, self.prefix_lookups),
            "prefix_blocks_indexed": len(self._prefix_index),
            "blocks_deduped": shared,
            "dedup_ratio": shared / max(1, shared + fresh),
        }

    # ------------------------------------------------------ write paths
    def ensure_capacity(self, pt: PageTable, n_tokens: int):
        """Make the next write (positions up to ``n_tokens``) safe: grow the
        table block by block and copy-on-write a shared tail block so
        appends never mutate another sequence's data."""
        if n_tokens > pt.num_tokens and pt.num_tokens < pt.capacity:
            self._unshare(pt, pt.num_tokens // self.block_size)
        while pt.capacity < n_tokens:
            pt.blocks.append(self.allocator.alloc())

    def _unshare(self, pt: PageTable, page_idx: int):
        bid = pt.blocks[page_idx]
        if not self.allocator.is_shared(bid):
            return
        new = self.allocator.alloc()
        for shard in self.shards:
            for pool in shard.values():
                bits(pool)[:, new] = bits(pool)[:, bid]
        self._release_block(bid)
        pt.blocks[page_idx] = new

    def _put_pages(self, bids: np.ndarray, k_pages, v_pages):
        """In-place bulk page write of full-hkv pages (host arrays or
        tensors), each shard taking its kv-head slice. The page axis is
        padded to a power of two, padding rows (zeros) aimed at the null
        block."""
        pages = len(bids)
        width = _pow2_pad(max(pages, 1))
        row = np.full((width,), NULL_BLOCK, np.int64)
        row[:pages] = bids
        for name, host in (("k", k_pages), ("v", v_pages)):
            full = bits(host_as(host, self.shards[0][name].dtype))
            if width != pages:
                pad = full.new_zeros((full.shape[0], width - pages,
                                      *full.shape[2:]))
                full = torch.cat([full, pad], dim=1)
            for i, shard in enumerate(self.shards):
                pool = bits(shard[name])
                hl = pool.shape[3]
                pool[:, torch.from_numpy(row).to(pool.device)] = \
                    full[:, :, :, i * hl:(i + 1) * hl].to(pool.device)

    def write_prefill(self, pt: PageTable, k_pre, v_pre):
        """Scatter prefill KV (L, plen, hkv, hd), full-hkv host arrays or
        tensors, into the sequence's blocks: one in-place write per shard
        and pool, the last partial page zero-padded."""
        L, plen = k_pre.shape[0], k_pre.shape[1]
        self.ensure_capacity(pt, plen)
        pages = self.pages_for(plen)
        pad = pages * self.block_size - plen
        bids = np.asarray(pt.blocks[:pages], np.int64)

        def paged(pre):
            pre = bits(host_as(pre, self.shards[0]["k"].dtype))
            if pad:
                pre = torch.cat([pre, pre.new_zeros((L, pad,
                                                     *pre.shape[2:]))], dim=1)
            return pre.reshape(L, pages, self.block_size, *pre.shape[2:])

        self._put_pages(bids, paged(k_pre), paged(v_pre))
        pt.num_tokens = plen

    # ------------------------------------------------- swap (host pages)
    def gather(self, pt: PageTable) -> Tuple[np.ndarray, np.ndarray]:
        """Copy a sequence's live pages to host memory (L, pages, blk, hkv,
        hd) — O(dirty pages), not O(max_len)."""
        return self.gather_range(pt, 0, len(pt.blocks))

    def gather_range(self, pt: PageTable, lo: int,
                     hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """Copy pages [lo, hi) of a sequence to host memory (full pages of
        a live session are content-frozen, so they can stream while it
        decodes)."""
        def pages(name):
            parts = [bits(s[name])[:, torch.as_tensor(pt.blocks[lo:hi],
                                                      dtype=torch.long,
                                                      device=s[name].device)]
                     for s in self.shards]
            joined = parts[0] if len(parts) == 1 else torch.cat(
                [p.cpu() for p in parts], dim=3)
            return torch_to_numpy(joined.view(self.shards[0][name].dtype))
        return pages("k"), pages("v")

    def scatter(self, k_pages: np.ndarray, v_pages: np.ndarray,
                num_tokens: int) -> PageTable:
        """Rebind host pages to freshly allocated device blocks (swap-in)."""
        pages = k_pages.shape[1]
        blocks = self.allocator.alloc_many(pages)
        self._put_pages(np.asarray(blocks, np.int64), k_pages, v_pages)
        return PageTable(self.block_size, blocks, num_tokens)
