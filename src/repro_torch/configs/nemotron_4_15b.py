"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=24576, vocab=256000, mlp="relu2")

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, mlp="relu2")
