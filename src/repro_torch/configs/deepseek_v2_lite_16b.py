"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora=512,
2 shared + 64 routed experts top-6 (assignment string also mentions "160
routed" which belongs to full V2 — we follow the explicit `MoE 64e top-6`;
see DESIGN.md §4). First layer dense with d_ff=10944 per the HF config.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                      # routed-expert hidden
    vocab_size=102400,
    act="silu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408),
    first_dense_layers=1,
    first_dense_d_ff=10944,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, q_lora_rank=0),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256, first_dense_d_ff=96,
        moe=MoEConfig(n_experts=4, n_shared_experts=1, top_k=2, d_ff_expert=32),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )
