"""Whisper-tiny [arXiv:2212.04356; unverified].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865; encoder-decoder. The
conv audio frontend is a STUB — ``input_specs()`` feeds precomputed frame
embeddings of shape (batch, enc_len=1500, d_model). Decoder runs at the
assigned shape's seq_len (a stress configuration, see DESIGN.md §4).
Whisper uses learned absolute positions; rotary_pct=0 disables RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                     # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu_mlp",                 # plain GELU MLP
    rotary_pct=0.0,                 # learned absolute positions instead
    is_encoder_decoder=True,
    enc_len=1500,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=128, vocab_size=256, enc_len=16)
