"""internvl2-26b — VLM backbone (InternViT frontend is a stub providing
precomputed patch embeddings) [arXiv:2404.16821; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, mlp_act="swiglu",
    frontend="vision", frontend_tokens=256,
)

REDUCED = ModelConfig(
    name="internvl2-reduced", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, mlp_act="swiglu",
    frontend="vision", frontend_tokens=16,
)
