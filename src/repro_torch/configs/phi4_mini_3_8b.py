"""phi4-mini-3.8b — dense GQA, RoPE + SwiGLU [arXiv:2412.08905; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064, mlp_act="swiglu",
)

REDUCED = ModelConfig(
    name="phi4-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, mlp_act="swiglu",
)
