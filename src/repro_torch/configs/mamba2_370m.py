"""Mamba2-370M [arXiv:2405.21060; unverified].

48L d_model=1024, attention-free SSD (state-space duality), ssm_state=128,
vocab=50280. d_ff=0: the Mamba-2 block subsumes the channel mixer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    rotary_pct=0.0,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  conv_kernel=4, chunk=256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      conv_kernel=4, chunk=8),
    )
