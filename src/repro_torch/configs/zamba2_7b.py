"""Zamba2-7B [arXiv:2411.15242; unverified].

81L d_model=3584, Mamba-2 backbone (ssm_state=64) with a SHARED attention
block (32H, kv=32 => MHA; d_ff=14336 MLP) applied every 6 layers,
weight-shared across applications. vocab=32000.

long_500k policy: the shared attention block uses a 32k sliding-window KV at
decode so 524k-token sessions keep bounded state (DESIGN.md §8.5).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    act="gelu",
    rope_theta=10000.0,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  conv_kernel=4, chunk=256),
    attn_every=6,
    attn_window=32768,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, attn_every=2, attn_window=0,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      conv_kernel=4, chunk=8),
    )
