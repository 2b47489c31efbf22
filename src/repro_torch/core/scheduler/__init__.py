from repro_torch.core.scheduler.drf import DRFAccountant
from repro_torch.core.scheduler.policies import (TOKEN_ALLOTMENTS, TOKEN_QUANTA,
                                           FIFOPolicy, MLFQPolicy, Policy,
                                           PriorityQueuePolicy,
                                           RoundRobinPolicy, make_policy,
                                           token_mlfq)
from repro_torch.core.scheduler.ratelimit import (AdmissionController,
                                            AIMDController, TokenBucket)
from repro_torch.core.scheduler.scenarios import SCENARIOS, Scenario, make_turns
from repro_torch.core.scheduler.simulator import (Metrics, SimConfig, Simulator,
                                            run_policy)
from repro_torch.core.scheduler.task import (QueueClass, Turn, TurnState,
                                       ZOMBIE_THRESHOLD_S)

__all__ = [
    "DRFAccountant", "FIFOPolicy", "MLFQPolicy", "Policy",
    "PriorityQueuePolicy", "RoundRobinPolicy", "make_policy",
    "TOKEN_ALLOTMENTS", "TOKEN_QUANTA", "token_mlfq",
    "AdmissionController", "AIMDController", "TokenBucket",
    "SCENARIOS", "Scenario", "make_turns",
    "Metrics", "SimConfig", "Simulator", "run_policy",
    "QueueClass", "Turn", "TurnState", "ZOMBIE_THRESHOLD_S",
]
