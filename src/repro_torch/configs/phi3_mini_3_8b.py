"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064)

SMOKE = ModelConfig(
    name="phi3-mini-3.8b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256)
