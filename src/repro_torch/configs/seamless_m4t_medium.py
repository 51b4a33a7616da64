"""seamless-m4t-medium [audio]: enc-dec multimodal backbone [arXiv:2308.11596; hf].

The assigned listing says 12L; m4t-medium pairs a 12-layer speech/text encoder with a
12-layer text decoder, so enc_layers=dec_layers=12.  The audio frontend is a stub:
``input_specs`` yields precomputed frame embeddings (B, S_src, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    enc_layers=12, dec_layers=12)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, enc_layers=2, dec_layers=2)
