"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block [arXiv:2411.15242;
unverified].

81 Mamba2 layers; one *shared* (weight-tied) attention+MLP block is interposed every
``attn_every`` inner layers (the Zamba2 design re-uses a single transformer block).
ssm_state=64 per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab=32000, ssm_state=64, ssm_heads=112,
    ssm_chunk=128, attn_every=6)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, ssm_state=16, ssm_heads=2, ssm_chunk=16,
    attn_every=2)
