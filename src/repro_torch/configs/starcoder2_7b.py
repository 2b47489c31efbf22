"""StarCoder2-7B [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152; GQA + RoPE.
(HF config uses a plain GELU MLP; we keep the assignment's d_ff with a GeGLU
formulation toggled off — act="gelu_mlp" selects the non-gated MLP.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    act="gelu_mlp",                 # non-gated GELU MLP per StarCoder2
    rope_theta=100000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256)
