"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision tower is a stub; ``input_specs`` provides precomputed patch
embeddings for ``image_frac`` of the sequence plus 3D (t,h,w) M-RoPE position ids.
head_dim=128; mrope_sections=(16,24,24) halves-of-head-dim split as in the release.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128, mrope=True,
    mrope_sections=(16, 24, 24), image_frac=0.25)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, mrope=True,
    mrope_sections=(4, 2, 2), image_frac=0.25)
