"""Llama-4 Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 16 experts top-1
plus a shared expert. Early-fusion multimodal frontend is out of scope — the
text backbone is what the assignment exercises.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    act="silu",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, n_shared_experts=1, top_k=1, d_ff_expert=8192),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, n_shared_experts=1, top_k=1, d_ff_expert=64),
    )
