"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256, mlp_act="swiglu",
    rope_theta=5e5,
)

REDUCED = ModelConfig(
    name="llama3-reduced", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, mlp_act="swiglu",
)
