"""Serving layer of the port: the paged engine, the dense slot engine, their
AgentRM adapters, the error taxonomy and the overload autopilot."""
from repro_torch.serving.autopilot import AutopilotConfig, SLOAutopilot
from repro_torch.serving.backend import (EngineBackend, PagedEngineBackend,
                                        SerializedPagedBackend,
                                        byte_tokenize)
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.errors import (BackpressureError, EngineCrashError,
                                        EngineError, EngineLostError,
                                        KVPressureError, MigrationError,
                                        PoisonedRowError, StepTimeoutError,
                                        SwapCorruptionError, SwapIOError,
                                        TransientStepError)
from repro_torch.serving.paging import (BlockAllocator, OutOfBlocksError,
                                        PageTable, PagedInferenceEngine,
                                        PagedKVCache, PagedRequest,
                                        SwapManager, budget_buckets)

__all__ = ["AutopilotConfig", "SLOAutopilot", "BackpressureError",
           "EngineBackend", "PagedEngineBackend", "SerializedPagedBackend",
           "byte_tokenize", "InferenceEngine", "Request", "BlockAllocator",
           "EngineError", "OutOfBlocksError", "PageTable",
           "PagedInferenceEngine", "PagedKVCache", "PagedRequest",
           "SwapManager", "budget_buckets", "EngineCrashError",
           "EngineLostError", "KVPressureError", "MigrationError",
           "PoisonedRowError", "StepTimeoutError", "SwapCorruptionError",
           "SwapIOError", "TransientStepError"]
