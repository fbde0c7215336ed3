"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=16384,
    sliding_window=4096, mlp_act="swiglu",
)

REDUCED = ModelConfig(
    name="mixtral-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    moe_num_experts=4, moe_top_k=2, moe_d_ff=128,
    sliding_window=64, mlp_act="swiglu",
)
