from repro_torch.serving.autopilot import AutopilotConfig, SLOAutopilot
from repro_torch.serving.backend import (EngineBackend, PagedEngineBackend,
                                   SerializedPagedBackend, byte_tokenize)
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.errors import (BackpressureError, EngineCrashError,
                                  EngineError, EngineLostError,
                                  KVPressureError, MigrationError,
                                  PoisonedRowError, StepTimeoutError,
                                  SwapCorruptionError, SwapIOError,
                                  TransientStepError)
from repro_torch.serving.journal import SessionJournal
from repro_torch.serving.paging import (BlockAllocator, DiskTierKVSwapStore,
                                  OutOfBlocksError, PageTable,
                                  PagedInferenceEngine, PagedKVCache,
                                  PagedRequest, SwapManager, budget_buckets)

__all__ = ["AutopilotConfig", "SLOAutopilot", "BackpressureError",
           "EngineBackend", "PagedEngineBackend", "SerializedPagedBackend",
           "byte_tokenize", "InferenceEngine", "Request", "BlockAllocator",
           "DiskTierKVSwapStore", "EngineError", "OutOfBlocksError",
           "PageTable", "PagedInferenceEngine", "PagedKVCache",
           "PagedRequest", "SwapManager", "budget_buckets",
           "EngineCrashError", "EngineLostError", "KVPressureError",
           "MigrationError", "PoisonedRowError", "StepTimeoutError",
           "SwapCorruptionError", "SwapIOError", "TransientStepError",
           "SessionJournal"]
