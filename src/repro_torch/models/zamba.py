"""Zamba2-style hybrid: Mamba2 backbone + one *shared* (weight-tied) attention+MLP
block interposed every ``attn_every`` inner layers; the reference's
``models/zamba.py``.

Layer layout for n_layers=81, attn_every=6: 13 super-blocks of (6 mamba layers +
shared attention), then 3 tail mamba layers.  The shared block's KV cache has
13 entries (one per application).  ``mamba_tail`` holds ``max(tail, 1)``
layers, as the reference's tree does: with no tail its one layer goes unused.

The state is the reference's ``{"conv", "ssd", "k", "v", "len"}`` with ``len``
a Python int.  A call returns new ``conv``/``ssd`` (the given ones are left as
they were) and writes the shared block's K/V into the given cache in place,
at ``len``: one token against the cache, or a segment that attends only
within itself (the reference's prefill "from scratch", whatever the cache
holds).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import (MambaLayer, mamba_layer_fwd, mamba_layer_init,
                                    mamba_layer_specs)
from repro_torch.models.transformer import LM, Block, check_layers, layer_specs


def _split(cfg: ModelConfig) -> tuple[int, int, int]:
    k = cfg.attn_every
    n_super = cfg.n_layers // k
    tail = cfg.n_layers - n_super * k
    return n_super, k, tail


def shared_block_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    return {"attn": L.attention_init(gen, cfg, device=device),
            "mlp": L.mlp_init(gen, cfg, device=device),
            "norm1": L.oinit((cfg.d_model,), device), "norm2": L.oinit((cfg.d_model,), device)}


class Zamba(LM):
    """Embedding, ``mamba_main`` (n_super lists of ``attn_every``
    ``MambaLayer``), ``mamba_tail``, the ``shared`` ``Block``, final norm."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(cfg, params)
        n_super, k, tail = _split(cfg)
        self.mamba_main = nn.ModuleList(nn.ModuleList(MambaLayer(cfg, lp) for lp in group)
                                        for group in params["mamba_main"])
        check_layers(len(self.mamba_main), n_super, "super-blocks")
        for group in self.mamba_main:
            check_layers(len(group), k, "layers in a super-block")
        self.mamba_tail = nn.ModuleList(MambaLayer(cfg, lp) for lp in params["mamba_tail"])
        check_layers(len(self.mamba_tail), max(tail, 1), "tail layers")
        self.shared = Block(cfg, params["shared"])

    def tree(self) -> dict[str, Any]:
        return {**self._common_tree(),
                "mamba_main": [[lp.tree() for lp in group] for group in self.mamba_main],
                "mamba_tail": [lp.tree() for lp in self.mamba_tail],
                "shared": self.shared.tree()}

    def _mambas(self):
        """The mamba layers in order, each with the super-block it closes
        (None inside a super-block and in the tail)."""
        n_super, k, tail = _split(self.cfg)
        for si, group in enumerate(self.mamba_main):
            for j, lp in enumerate(group):
                yield lp, si if j == k - 1 else None
        for lp in list(self.mamba_tail)[:tail]:
            yield lp, None

    def _forward(self, tokens: torch.Tensor, state: dict | None, mode: str, remat=None
                 ) -> tuple[torch.Tensor, dict]:
        """The reference's ``_forward``: ``mode`` "train" (no cache; each
        Mamba2 layer and shared-block call under ``remat``), or
        "prefill"/"decode" (one token against the cache, or a segment)."""
        cfg = self.cfg
        x = L.embed_lookup(self.embed, tokens, cfg)
        B, S, _ = x.shape
        base = int(state["len"]) if state is not None else 0
        positions = base + torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        cos, sin = self._rope(positions)
        st = state or init_state(cfg, B, S, device=x.device)
        conv = st["conv"].to(x.dtype)
        convs, ssds = [], []
        for i, (lp, si) in enumerate(self._mambas()):
            x, ns = L.remat(remat, mamba_layer_fwd, cfg, lp, x,
                            {"conv": conv[i], "ssd": st["ssd"][i]})
            convs.append(ns["conv"])
            ssds.append(ns["ssd"])
            if si is None:
                continue
            if mode == "train":
                x = L.remat(remat, self.shared.train_fwd, x, cos, sin)[0]
            elif S == 1:
                x = self.shared.decode(x, cos, sin, st["k"][si], st["v"][si], base)
            else:  # prefill from scratch: the segment IS the cache prefix
                x, k, v = self.shared(x, cos, sin)
                _write(st["k"][si], k, base)
                _write(st["v"][si], v, base)
        new_state = {"conv": torch.stack(convs), "ssd": torch.stack(ssds),
                     "k": st["k"], "v": st["v"], "len": base + S}
        return self._finish(x), new_state

    def forward(self, tokens: torch.Tensor, remat=None) -> torch.Tensor:
        """The reference's ``_forward`` in "train" mode: the final-normed
        hidden states (B, S, D)."""
        return self._forward(tokens, None, "train", remat)[0]

    def train_loss(self, batch: Mapping[str, torch.Tensor], remat=None) -> torch.Tensor:
        """The reference's ``train_loss``: the next-token loss of the "train"
        forward."""
        return L.cross_entropy(self.logits(self(batch["tokens"], remat)), batch["labels"])

    def prefill(self, tokens: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        x, ns = self._forward(tokens, state, "prefill")
        return self.logits(x[:, -1:]), ns

    def decode_step(self, token: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        x, ns = self._forward(token, state, "decode")
        return self.logits(x), ns


def _write(cache: torch.Tensor, new: torch.Tensor, base: int) -> None:
    """``dynamic_update_slice`` of ``new`` (B, S, ...) into ``cache`` (B, M,
    ...) at row ``base``, the start clamped so that the slice fits."""
    S, M = new.shape[1], cache.shape[1]
    if S > M:
        raise ValueError(f"a {S}-token segment does not fit a {M}-row cache")
    start = min(base, M - S)
    cache[:, start:start + S] = new.to(cache.dtype)


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None,
         train: bool = False) -> Zamba:
    """Random weights with the reference's shapes and scales, drawn in f32 on
    ``device`` (the card unless given) one layer at a time; with ``train``
    kept in f32 to take gradients (``LM.trainable``)."""
    n_super, k, tail = _split(cfg)
    device = L.resolve_device(device)
    layer = lambda: mamba_layer_init(generator, cfg, device)
    params = {"embed": L.embed_init(generator, cfg, device=device),
              "mamba_main": ((layer() for _ in range(k)) for _ in range(n_super)),
              "mamba_tail": (layer() for _ in range(max(tail, 1))),
              "shared": shared_block_init(generator, cfg, device),
              "final_norm": L.oinit((cfg.d_model,), device)}
    return (Zamba.trainable if train else Zamba)(cfg, params)


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's logical specs of the param tree: ``mamba_main`` under
    ``("stacked2", ...)`` (super-block and layer dimensions), ``mamba_tail``
    under ``("stacked", ...)``; the shared block is a dense layer's."""
    mspec = mamba_layer_specs(cfg)
    return {"embed": L.embed_specs(cfg), "mamba_main": ("stacked2", mspec),
            "mamba_tail": ("stacked", mspec), "shared": layer_specs(cfg),
            "final_norm": (None,)}


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """Mamba states for all layers + shared-attention KV cache (n_super entries)."""
    dtype = dtype or cfg.dtype
    device = L.resolve_device(device)
    n_super, _, _ = _split(cfg)
    d_in = 2 * cfg.d_model
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = d_in // H
    nl = cfg.n_layers
    kv = (n_super, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"conv": torch.zeros((nl, batch, 3, d_in), dtype=dtype, device=device),
            "ssd": torch.zeros((nl, batch, H, P, N), dtype=torch.float32, device=device),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device), "len": 0}


def state_specs(cfg: ModelConfig, tp_size: int = 16, batch: int | None = None,
                fsdp_size: int = 16) -> dict:
    heads_ok = cfg.n_kv_heads % tp_size == 0
    batch_ok = batch is None or batch % fsdp_size == 0
    if heads_ok and batch_ok:
        kv = (None, "fsdp", None, "tp", None)
    elif heads_ok:
        # tiny batch (long-context decode): the data axis is idle -- shard the
        # cache sequence over it instead of replicating GBs per chip
        kv = (None, None, "fsdp", "tp", None)
    else:
        kv = (None, "fsdp", "tp", None, None)
    return {"conv": (None, "fsdp", None, ("tp", 2 * cfg.d_model)),
            "ssd": (None, "fsdp", ("tp", cfg.ssm_heads), None, None),
            "k": kv, "v": kv, "len": ()}
