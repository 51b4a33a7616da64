"""rwkv6-7b [ssm]: Finch, attention-free, data-dependent decay [arXiv:2404.05892; hf].

head_size=64 => 64 heads at d_model=4096.  ssm_state is the per-head (64,64) wkv
state; ssm_chunk is the chunked-scan block length for train/prefill.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv_heads=64, d_ff=14336, vocab=65536, ssm_state=64, ssm_heads=64,
    ssm_chunk=128)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, ssm_state=16, ssm_heads=4, ssm_chunk=16)
