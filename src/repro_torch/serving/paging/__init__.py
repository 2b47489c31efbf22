"""Paged KV-cache subsystem: OS-style virtual memory for agent sessions.

  allocator — fixed-size KV blocks, free list, refcounts, page tables
  pool      — PagedKVCache: the pooled bytes + copy-on-write + page moves
  swap      — SwapManager: host-RAM tier, LRU eviction, demand paging
  engine    — PagedInferenceEngine: block-granular admission, retained
              sessions, O(pages) hibernation

The Pallas paged-attention decode kernel lives in
``repro_torch.kernels.paged_attention``.
"""
from repro_torch.serving.paging.allocator import (BlockAllocator, NULL_BLOCK,
                                            OutOfBlocksError, PageTable)
from repro_torch.serving.paging.disktier import DiskTierKVSwapStore
from repro_torch.serving.paging.engine import (EngineError,
                                         PagedInferenceEngine,
                                         PagedRequest, budget_buckets)
from repro_torch.serving.paging.pool import PagedKVCache
from repro_torch.serving.paging.swap import SwapManager

__all__ = ["BlockAllocator", "DiskTierKVSwapStore", "EngineError",
           "NULL_BLOCK", "OutOfBlocksError", "PageTable",
           "PagedInferenceEngine", "PagedRequest", "PagedKVCache",
           "SwapManager", "budget_buckets"]
