"""The port's benchmark: AgentRM agent fleets through the captured megastep.

``python3 -m agentbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. The harness imports
the program (``repro_torch``) and never JAX or the JAX package;
``agentbench.reference`` imports neither, nor the program.
"""
