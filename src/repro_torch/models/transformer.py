"""Decoder-only transformer LM, dense family: the reference's ``models/transformer.py``.

An ``nn.Module`` per block (``Block``: its ``Attention`` and ``MLP`` weights
and two norm scales) in an ``nn.ModuleList`` under ``Transformer``.  The
reference stacks its layers and scans them; here each block holds its own
slice and the model loops over them.  Inference only: no remat, no aux loss.

Serving weights are stored once in ``cfg.dtype`` (norm scales in f32), which
gives the bits of the reference's per-use cast of its f32 weights.

The KV cache is the reference's ``{"k", "v", "len"}`` with ONE length for
every slot (``len`` a Python int here): ``decode_step`` writes all slots at
``pos = len`` and attends to ``len + 1`` positions.  A request's output
therefore depends on what is served beside it (ROADMAP §3 R3); the port keeps
that so that it gives the reference's results.  The cache's tensors are
updated in place, and the returned cache shares them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

NORMS = ("norm1", "norm2")


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is not ported yet: ROADMAP §1 "
                                  "item 4, the other families' serving")


class Attention(L.Weights):
    """wq, wk, wv, wo (and bq, bk, bv with ``qkv_bias``) in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class MLP(L.Weights):
    """w_gate (swiglu), w_up, w_down in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class Embedding(L.Weights):
    """embedding (and lm_head unless tied) in ``cfg.dtype``, padded vocab."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class Block(nn.Module):
    """One layer: pre-norm attention and MLP with residuals."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, params["attn"])
        self.mlp = MLP(cfg, params["mlp"])
        self.norms = L.Weights({k: params[k] for k in NORMS})

    def tree(self) -> dict[str, Any]:
        return {"attn": self.attn.tree(), "mlp": self.mlp.tree(), **self.norms.tree()}

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """The reference's ``_layer_fwd`` over a whole sequence (causal):
        returns the new residual stream and the rotated k and v."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = L.rms_norm(x, self.norms["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(self.attn, h, cfg)
        q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        attn = L.flash_attention(q, k, v, causal=True)
        x = x + attn.reshape(B, S, -1) @ self.attn["wo"].to(x.dtype)
        h = L.rms_norm(x, self.norms["norm2"], cfg.norm_eps)
        return x + L.mlp_apply(self.mlp, h, cfg), k, v

    def decode(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               kc: torch.Tensor, vc: torch.Tensor, pos: int) -> torch.Tensor:
        """One token per slot against this layer's cache ``kc``/``vc`` (B, S,
        Hkv, hd), written in place at ``pos``; as the reference's
        ``dynamic_update_slice``, a ``pos`` past the end writes the last row."""
        cfg = self.cfg
        B = x.shape[0]
        h = L.rms_norm(x, self.norms["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(self.attn, h, cfg)
        q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        row = min(pos, kc.shape[1] - 1)
        kc[:, row] = k[:, 0].to(kc.dtype)
        vc[:, row] = v[:, 0].to(vc.dtype)
        attn = L.attention_decode(q, kc, vc, pos + 1)
        x = x + attn.reshape(B, 1, -1) @ self.attn["wo"].to(x.dtype)
        h = L.rms_norm(x, self.norms["norm2"], cfg.norm_eps)
        return x + L.mlp_apply(self.mlp, h, cfg)


class Transformer(nn.Module):
    """The dense LM: embedding, ``blocks``, final norm, logits.

    ``params`` is the reference's tree with the layers as a list of per-layer
    dicts: ``{"embed": {...}, "layers": [{"attn", "mlp", "norm1", "norm2"}, ...],
    "final_norm": ...}``; weights are stored in ``cfg.dtype``, norm scales f32."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__()
        _require_dense(cfg)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers for a {cfg.n_layers}-layer "
                             "config")
        self.cfg = cfg
        self.embed = Embedding(cfg, params["embed"])
        self.blocks = nn.ModuleList(Block(cfg, lp) for lp in params["layers"])
        self.final = L.Weights({"final_norm": params["final_norm"]})
        freqs = torch.from_numpy(L.rope_freqs(cfg.hd, cfg.rope_theta))
        self.register_buffer("freqs", freqs.to(self.embed["embedding"].device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def tree(self) -> dict[str, Any]:
        """The weights as ``Transformer(cfg, ...)`` takes them."""
        return {"embed": self.embed.tree(), "layers": [b.tree() for b in self.blocks],
                "final_norm": self.final["final_norm"].data}

    def with_dtype(self, dtype: torch.dtype) -> "Transformer":
        """This model's weights cast to ``dtype`` (norm scales stay f32), under
        a config of that dtype: what the reference computes from the same f32
        weights when its config says ``dtype``."""
        return Transformer(dataclasses.replace(self.cfg, dtype=dtype), self.tree())

    def _rope(self, positions: torch.Tensor):
        return L.rope_cos_sin(positions, self.freqs)

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(x, self.final["final_norm"], self.cfg.norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.lm_logits(self.embed, x, self.cfg)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None
                ) -> torch.Tensor:
        """-> the final-normed hidden states (B, S, D)."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        cos, sin = self._rope(positions)
        for blk in self.blocks:
            x, _, _ = blk(x, cos, sin)
        return self._finish(x)

    def prefill(self, tokens: torch.Tensor, cache: dict, positions: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the full prompt, fill the cache from position 0, return the
        logits of the last position and the cache with ``len`` = S."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        B, S, _ = x.shape
        if S > cache["k"].shape[2]:
            raise ValueError(f"a {S}-token prompt does not fit a {cache['k'].shape[2]}-row "
                             "cache")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        cos, sin = self._rope(positions)
        for i, blk in enumerate(self.blocks):
            x, k, v = blk(x, cos, sin)
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        logits = self.logits(self._finish(x)[:, -1:])
        return logits, {"k": cache["k"], "v": cache["v"], "len": S}

    def decode_step(self, token: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """One new token per slot against the cache.  token: (B, 1) int."""
        B = token.shape[0]
        pos = int(cache["len"])
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        x = L.embed_lookup(self.embed, token, self.cfg)
        cos, sin = self._rope(positions)
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cos, sin, cache["k"][i], cache["v"][i], pos)
        logits = self.logits(self._finish(x))
        return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}


# ------------------------------------------------------------------------ params

def layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    return {"attn": L.attention_init(gen, cfg, device=device),
            "mlp": L.mlp_init(gen, cfg, device=device),
            "norm1": L.oinit((cfg.d_model,), device), "norm2": L.oinit((cfg.d_model,), device)}


def init(cfg: ModelConfig, generator: torch.Generator | None = None,
         device=None) -> Transformer:
    """A randomly initialised ``Transformer`` with the reference's shapes and
    scales: f32 draws from ``generator`` on ``device``, stored in ``cfg.dtype``."""
    _require_dense(cfg)
    params = {"embed": L.embed_init(generator, cfg, device=device),
              "layers": [layer_init(generator, cfg, device) for _ in range(cfg.n_layers)],
              "final_norm": L.oinit((cfg.d_model,), device)}
    return Transformer(cfg, params)


# ----------------------------------------------------------------------- serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}
