"""Seamless-M4T-style encoder-decoder backbone (audio family): the reference's
``models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, D).  The encoder's layers are
``Block``s with bidirectional attention; a decoder layer (``DecLayer``) has
causal self-attention, cross-attention to the encoder's memory, and an MLP.

The cache is the reference's ``{"k", "v", "ck", "cv", "len"}`` with ``len`` a
Python int: ``prefill`` writes the self-attention K/V in place and replaces
the cross K/V with the memory's (as long as the memory); ``decode_step``
attends to all of ``ck``'s rows.  A cache from ``init_cache`` alone holds a
cross memory of zeros, which is what a serving engine that never calls
``prefill`` with frames attends to (ROADMAP §3 R4, the reference's too).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (LM, MLP, Attention, Block, check_layers,
                                            layer_specs, self_attend)

SRC_RATIO = 8  # decoder length = encoder length // SRC_RATIO for train/prefill
DEC_NORMS = ("norm1", "norm2", "norm3")


def enc_layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    return {"attn": L.attention_init(gen, cfg, device=device),
            "mlp": L.mlp_init(gen, cfg, device=device),
            "norm1": L.oinit((cfg.d_model,), device), "norm2": L.oinit((cfg.d_model,), device)}


def dec_layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    return {"self": L.attention_init(gen, cfg, device=device),
            "cross": L.attention_init(gen, cfg, device=device),
            "mlp": L.mlp_init(gen, cfg, device=device),
            **{k: L.oinit((cfg.d_model,), device) for k in DEC_NORMS}}


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {"self": L.attention_specs(cfg), "cross": L.attention_specs(cfg),
            "mlp": L.mlp_specs(cfg), **{k: (None,) for k in DEC_NORMS}}


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's logical specs of the param tree (layers stacked; an
    encoder layer's are a dense layer's)."""
    return {"embed": L.embed_specs(cfg), "enc": ("stacked", layer_specs(cfg)),
            "dec": ("stacked", dec_layer_specs(cfg)), "enc_norm": (None,),
            "final_norm": (None,)}


class DecLayer(nn.Module):
    """One decoder layer: ``self`` and ``cross`` attention, ``mlp``, three norms."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.self_attn = Attention(cfg, params["self"])
        self.cross = Attention(cfg, params["cross"])
        self.mlp = MLP(cfg, params["mlp"])
        self.norms = L.Weights({k: params[k] for k in DEC_NORMS})

    def tree(self) -> dict[str, Any]:
        return {"self": self.self_attn.tree(), "cross": self.cross.tree(),
                "mlp": self.mlp.tree(), **self.norms.tree()}

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = L.rms_norm(x, self.norms["norm3"], self.cfg.norm_eps)
        return x + L.mlp_apply(self.mlp, h, self.cfg)

    def cross_kv(self, memory: torch.Tensor):
        """The memory projected to this layer's cross K and V (B, S_src, Hkv, hd)."""
        cfg, dt = self.cfg, memory.dtype
        B = memory.shape[0]
        k = (memory @ self.cross["wk"].to(dt)).reshape(B, -1, cfg.n_kv_heads, cfg.hd)
        v = (memory @ self.cross["wv"].to(dt)).reshape(B, -1, cfg.n_kv_heads, cfg.hd)
        return k, v

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                memory: torch.Tensor):
        """A whole target segment (causal) against the memory: returns the
        new residual stream, the rotated self-attention k and v, and the
        cross k and v."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = L.rms_norm(x, self.norms["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(self.self_attn, h, cfg)
        q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        attn = L.flash_attention(q, k, v, causal=True)
        x = x + attn.reshape(B, S, -1) @ self.self_attn["wo"].to(x.dtype)
        ck, cv = self.cross_kv(memory)
        h = L.rms_norm(x, self.norms["norm2"], cfg.norm_eps)
        q = (h @ self.cross["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
        attn = L.flash_attention(q, ck, cv, causal=False)
        x = x + attn.reshape(B, S, -1) @ self.cross["wo"].to(x.dtype)
        return self._mlp(x), k, v, ck, cv

    def decode(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               kc: torch.Tensor, vc: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: int) -> torch.Tensor:
        cfg = self.cfg
        B = x.shape[0]
        x = x + self_attend(self.self_attn, self.norms["norm1"], x, cos, sin, kc, vc, pos,
                            cfg)
        h = L.rms_norm(x, self.norms["norm2"], cfg.norm_eps)
        qc = (h @ self.cross["wq"].to(x.dtype)).reshape(B, 1, cfg.n_heads, cfg.hd)
        cattn = L.attention_decode(qc, ck, cv, ck.shape[1])
        x = x + cattn.reshape(B, 1, -1) @ self.cross["wo"].to(x.dtype)
        return self._mlp(x)


class EncDec(LM):
    """Embedding, ``enc`` (``Block``s, bidirectional), ``enc_norm``, ``dec``
    (``DecLayer``s), final norm, logits."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(cfg, params)
        self.enc = nn.ModuleList(Block(cfg, lp) for lp in params["enc"])
        check_layers(len(self.enc), cfg.enc_layers, "encoder layers")
        self.dec = nn.ModuleList(DecLayer(cfg, lp) for lp in params["dec"])
        check_layers(len(self.dec), cfg.dec_layers, "decoder layers")
        self.enc_final = L.Weights({"enc_norm": params["enc_norm"]})

    def tree(self) -> dict[str, Any]:
        return {**self._common_tree(), "enc": [b.tree() for b in self.enc],
                "dec": [d.tree() for d in self.dec],
                "enc_norm": self.enc_final.tree()["enc_norm"]}

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)

    def encode(self, frames: torch.Tensor, remat=None) -> torch.Tensor:
        """frames: (B, S_src, D) stub frontend embeddings -> encoder memory;
        each layer under ``remat`` (``layers.remat``)."""
        x = frames.to(self.cfg.dtype)
        cos, sin = self._rope(self._positions(*x.shape[:2]))
        for blk in self.enc:
            x = L.remat(remat, blk.train_fwd, x, cos, sin, False)[0]
        return L.rms_norm(x, self.enc_final["enc_norm"], self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor, remat=None) -> torch.Tensor:
        """The reference's ``decode_train`` (its loss aside): the decoder's
        final-normed hidden states (B, S, D) against ``memory``."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        cos, sin = self._rope(self._positions(*tokens.shape))
        for lyr in self.dec:
            x = L.remat(remat, lyr, x, cos, sin, memory)[0]
        return self._finish(x)

    def train_loss(self, batch: Mapping[str, torch.Tensor], remat=None) -> torch.Tensor:
        """The reference's ``train_loss``: encode ``frames``, then the
        decoder's next-token loss against that memory."""
        memory = self.encode(batch["frames"], remat)
        x = self(batch["tokens"], memory, remat)
        return L.cross_entropy(self.logits(x), batch["labels"])

    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """Encode the source frames, project each layer's cross K/V, prefill
        the decoder prompt; -> (last position's logits, the cache)."""
        memory = self.encode(frames)
        B, S = tokens.shape
        if S > cache["k"].shape[2]:
            raise ValueError(f"a {S}-token prompt does not fit a {cache['k'].shape[2]}-row "
                             "cache")
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        cos, sin = self._rope(self._positions(B, S))
        cks, cvs = [], []
        for i, lyr in enumerate(self.dec):
            x, k, v, ck, cv = lyr(x, cos, sin, memory)
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
            cks.append(ck)
            cvs.append(cv)
        logits = self.logits(self._finish(x)[:, -1:])
        return logits, {"k": cache["k"], "v": cache["v"], "ck": torch.stack(cks),
                        "cv": torch.stack(cvs), "len": S}

    def decode_step(self, token: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        B = token.shape[0]
        pos = int(cache["len"])
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        x = L.embed_lookup(self.embed, token, self.cfg)
        cos, sin = self._rope(positions)
        for i, lyr in enumerate(self.dec):
            x = lyr.decode(x, cos, sin, cache["k"][i], cache["v"][i], cache["ck"][i],
                           cache["cv"][i], pos)
        return self.logits(self._finish(x)), dict(cache, len=pos + 1)


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None,
         train: bool = False) -> EncDec:
    """Random weights with the reference's shapes and scales, drawn in f32 on
    ``device`` (the card unless given) one layer at a time; with ``train``
    kept in f32 to take gradients (``LM.trainable``)."""
    device = L.resolve_device(device)
    params = {"embed": L.embed_init(generator, cfg, device=device),
              "enc": (enc_layer_init(generator, cfg, device) for _ in range(cfg.enc_layers)),
              "dec": (dec_layer_init(generator, cfg, device) for _ in range(cfg.dec_layers)),
              "enc_norm": L.oinit((cfg.d_model,), device),
              "final_norm": L.oinit((cfg.d_model,), device)}
    return (EncDec.trainable if train else EncDec)(cfg, params)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
               dtype: torch.dtype | None = None, device=None) -> dict:
    dtype = dtype or cfg.dtype
    device = L.resolve_device(device)
    kv = (cfg.dec_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    ckv = (cfg.dec_layers, batch, src_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ck": torch.zeros(ckv, dtype=dtype, device=device),
            "cv": torch.zeros(ckv, dtype=dtype, device=device), "len": 0}


def cache_specs(cfg: ModelConfig, tp_size: int = 16) -> dict:
    if cfg.n_kv_heads % tp_size == 0:
        kv = (None, "fsdp", None, "tp", None)
    else:
        kv = (None, "fsdp", "tp", None, None)
    return {"k": kv, "v": kv, "ck": kv, "cv": kv, "len": ()}
