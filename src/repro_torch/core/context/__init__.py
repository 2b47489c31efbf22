from repro_torch.core.context.baselines import (ContextStrategy, FIFOTruncation,
                                          MemGPTStyle, NoManagement,
                                          SlidingWindow)
from repro_torch.core.context.evaluate import evaluate, run_session
from repro_torch.core.context.manager import CLMConfig, ContextLifecycleManager
from repro_torch.core.context.message import (Entry, Message, Summary,
                                        count_tokens, window_tokens)
from repro_torch.core.context.psi import PressureGauge
from repro_torch.core.context.sessions import SESSIONS, SessionSpec, make_session
from repro_torch.core.context.summarizer import Summarizer
from repro_torch.core.context.tiers import ColdStore, WarmStore

STRATEGIES = {
    "no_management": NoManagement,
    "fifo_truncation": FIFOTruncation,
    "sliding_window": SlidingWindow,
    "memgpt_style": MemGPTStyle,
    "agentrm_clm": ContextLifecycleManager,
}

__all__ = [
    "ContextStrategy", "FIFOTruncation", "MemGPTStyle", "NoManagement",
    "SlidingWindow", "evaluate", "run_session", "CLMConfig",
    "ContextLifecycleManager", "Entry", "Message", "Summary", "count_tokens",
    "window_tokens", "PressureGauge", "SESSIONS", "SessionSpec",
    "make_session", "Summarizer", "ColdStore", "WarmStore", "STRATEGIES",
]
