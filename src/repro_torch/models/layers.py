"""Dense transformer building blocks in PyTorch: the reference's ``models/layers.py``.

Conventions, as the reference's:
  * a layer's weights are a mapping from the reference's names to tensors -- a
    plain dict, or a ``Weights`` module (``models/transformer.py`` holds one
    per attention, MLP and embedding), laid out as the reference's: ``x @ w``
    with ``w`` of shape (in, out);
  * compute runs in the activations' dtype: each weight is cast to it where
    it is used, a no-op for the port's serving weights (stored once in
    ``cfg.dtype``) and the reference's own cast of its f32 weights otherwise;
    norm scales stay f32, as ``rms_norm`` reads them;
  * the init functions draw f32 weights from a ``torch.Generator`` with the
    reference's shapes and scales (the draws themselves differ from JAX's);
  * the reference's ``shard``/``wcast`` sharding constraints are the identity
    without a mesh, and the port has no mesh yet (ROADMAP §1 item 3): they are
    dropped here, with the head padding ``flash_attention`` does under one.

Attention is plain torch ops in the reference's order of casts and sums
(f32 accumulation, the ``-1e30`` mask), not a library attention kernel.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

Params = Mapping[str, torch.Tensor]
NEG_INF = -1e30     # the reference's mask value


class Weights(nn.Module):
    """A layer's weights as frozen parameters, read by name like the
    reference's dicts (``p["wq"]``), so every function here takes either."""

    def __init__(self, params: Params, dtype: torch.dtype = torch.float32):
        super().__init__()
        for k, v in params.items():
            t = torch.as_tensor(v).to(dtype)
            self.register_parameter(k, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def tree(self) -> dict[str, torch.Tensor]:
        return {k: v.data for k, v in self._parameters.items()}


# --------------------------------------------------------------------- init helpers

def ninit(gen: torch.Generator | None, shape, scale: float | None = None,
          device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def zinit(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def oinit(shape, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


# ------------------------------------------------------------------------ norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ------------------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd)


def rope_cos_sin(pos: torch.Tensor, freqs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """pos (..., S) and f32 ``freqs`` (hd/2,) -> cos, sin of shape (..., S, 1, hd/2)."""
    ang = pos[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated by ``rope_cos_sin``'s tables (in f32, as the
    reference's bf16-times-f32 products are), back in x's dtype."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), pos: broadcastable to (..., S)."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    return rotate(x, *rope_cos_sin(pos, freqs))


# -------------------------------------------------------------------- attention

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 1024, kv_chunk: int = 1024,
                    kv_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention; never materializes (Sq, Sk) scores.

    q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd).  GQA handled by head repetition.
    kv_offset: absolute position of k[0] relative to q[0] (for cross-chunk decode).
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: {(Sq, q_chunk, Sk, kv_chunk)}")
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qb = q.reshape(B, nq, q_chunk, H, hd).float()
    kb = k.reshape(B, nk, kv_chunk, H, hd).float()
    vb = v.reshape(B, nk, kv_chunk, H, hd).float()
    outs = []
    for qi in range(nq):
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev) + kv_offset
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bqhd,bkhd->bhqk", qb[:, qi], kb[:, ki]) * scale
            if causal:
                k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb[:, ki])
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=1)                      # (B, nq, H, q_chunk, hd)
    out = out.transpose(2, 3).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int | torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, Hkv, hd); cache_len: an int or (B,) valid
    length.  Scores and the weighted sum accumulate in f32 (the cache is read
    in its storage dtype and widened exactly); ``p`` is cast to the cache's
    dtype first, as the reference does."""
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) / math.sqrt(hd)
    if isinstance(cache_len, int):
        if cache_len < S:
            s[..., max(cache_len, 0):] = NEG_INF
    else:
        pos = torch.arange(S, device=s.device)
        valid = pos[None, :] < cache_len.reshape(-1, 1)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(k_cache.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_init(gen: torch.Generator | None, cfg: ModelConfig,
                   d_model: int | None = None, device=None) -> dict[str, torch.Tensor]:
    D = d_model or cfg.d_model
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": ninit(gen, (D, H * hd), device=device),
        "wk": ninit(gen, (D, Hkv * hd), device=device),
        "wv": ninit(gen, (D, Hkv * hd), device=device),
        "wo": ninit(gen, (H * hd, D), scale=1.0 / math.sqrt(H * hd), device=device),
    }
    if cfg.qkv_bias:
        params |= {"bq": zinit((H * hd,), device), "bk": zinit((Hkv * hd,), device),
                   "bv": zinit((Hkv * hd,), device)}
    return params


def attention_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Project to (q, k, v) with head reshape; x (B, S, D)."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q.reshape(B, S, H, hd), k.reshape(B, S, Hkv, hd), v.reshape(B, S, Hkv, hd)


# ------------------------------------------------------------------------- MLPs

def mlp_init(gen: torch.Generator | None, cfg: ModelConfig, d_ff: int | None = None,
             device=None) -> dict[str, torch.Tensor]:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    down = 1.0 / math.sqrt(Fd)
    if cfg.mlp == "swiglu":
        return {"w_gate": ninit(gen, (D, Fd), device=device),
                "w_up": ninit(gen, (D, Fd), device=device),
                "w_down": ninit(gen, (Fd, D), scale=down, device=device)}
    return {"w_up": ninit(gen, (D, Fd), device=device),
            "w_down": ninit(gen, (Fd, D), scale=down, device=device)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp == "swiglu":
        g = F.silu(x @ p["w_gate"].to(dt))
        return (g * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    h = x @ p["w_up"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.square(F.relu(h)) if cfg.mlp == "relu2" else F.gelu(h, approximate="tanh")
    return h @ p["w_down"].to(dt)


# -------------------------------------------------------------------- embedding

VOCAB_PAD = 16  # the reference pads the vocab to a TP multiple; kept for its shapes


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def embed_init(gen: torch.Generator | None, cfg: ModelConfig,
               device=None) -> dict[str, torch.Tensor]:
    V, D = padded_vocab(cfg.vocab), cfg.d_model
    params = {"embedding": ninit(gen, (V, D), scale=1.0, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ninit(gen, (D, V), device=device)
    return params


def embed_lookup(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embedding"].to(cfg.dtype)[tokens]


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    logits = x @ w.to(x.dtype)
    if logits.shape[-1] != cfg.vocab:  # mask the vocab padding, in the logits' dtype
        logits[..., cfg.vocab:] = NEG_INF
    return logits
