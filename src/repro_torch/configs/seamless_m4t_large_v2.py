"""seamless-m4t-large-v2 — speech encoder-decoder backbone; the audio
frontend is a stub providing precomputed frame embeddings
[arXiv:2308.11596; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=8192, vocab_size=256206,
    mlp_act="gelu", frontend="audio",
)

REDUCED = ModelConfig(
    name="seamless-reduced", family="audio",
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    mlp_act="gelu", frontend="audio",
)
