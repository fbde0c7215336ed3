"""deepseek-moe-16b — fine-grained MoE: 64 routed experts top-6 + 2
shared, dense first layer [arXiv:2401.06066; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2, moe_d_ff=1408,
    first_dense_ff=10944, mlp_act="swiglu",
)

REDUCED = ModelConfig(
    name="deepseek-moe-reduced", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512,
    moe_num_experts=8, moe_top_k=2, moe_num_shared=2, moe_d_ff=32,
    first_dense_ff=128, mlp_act="swiglu",
)
