"""Model/config dataclasses shared by every assigned architecture.

The reference's ``configs/base.py`` with ``dtype`` a ``torch.dtype``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    mlp: str = "swiglu"         # swiglu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512   # GShard dispatch group (perf-tunable)
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 256        # chunked-scan block for train/prefill
    # --- hybrid (zamba2-style shared attention) ---
    attn_every: int = 0         # apply the shared attn block every k inner layers
    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- VLM ---
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    image_frac: float = 0.25    # fraction of train/prefill tokens that are patches

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when serving 500k-token contexts is deployable (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6*N*D roofline."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            per = D * D * 4 + D * F * 2 + D * 64 * 8  # timemix + channelmix + lora
            return emb + L * per
        attn = D * hd * self.n_heads + 2 * D * hd * self.n_kv_heads \
            + self.n_heads * hd * D
        if self.family == "moe":
            ffn = self.n_experts * 3 * D * F + D * self.n_experts
        elif self.mlp == "swiglu":
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        per = attn + ffn + 2 * D
        if self.family == "hybrid":
            # mamba2 inner layers + one shared attention/mlp block
            n_shared = max(1, L // max(1, self.attn_every))
            mamba = L * (2 * D * 2 * D + 2 * D * (self.ssm_state * 2 + self.ssm_heads)
                         + 2 * D * D)
            shared = attn + 3 * D * F + 2 * D
            return emb + mamba + shared + n_shared * 2 * D * D // 8
        if self.family == "encdec":
            enc = self.enc_layers * (attn + ffn + 2 * D)
            dec = self.dec_layers * (attn + attn + ffn + 3 * D)  # + cross-attn
            return emb + enc + dec
        return emb + L * per

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * D * F
        return dense + L * self.top_k * 3 * D * F


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
