"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE every 2nd
layer, 16 experts top-2 [arXiv:2403.19887; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    moe_num_experts=16, moe_top_k=2, moe_d_ff=14336, moe_layer_period=2,
    attn_period=8,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    mlp_act="swiglu",
)

REDUCED = ModelConfig(
    name="jamba-reduced", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    moe_num_experts=4, moe_top_k=2, moe_d_ff=128, moe_layer_period=2,
    attn_period=8,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=32,
    mlp_act="swiglu",
)
