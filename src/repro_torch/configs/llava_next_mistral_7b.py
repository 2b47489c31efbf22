"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The anyres vision
tower is a STUB — ``input_specs()`` provides precomputed patch embeddings
(batch, 576, d_model) that are prepended to the text embeddings; loss is
masked over image positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    act="silu",
    rope_theta=1000000.0,
    n_image_tokens=576,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, n_image_tokens=8)
