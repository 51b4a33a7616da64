"""RWKV6 (Finch) full model: attention-free LM, O(1)-state decode; the
reference's ``models/rwkv.py``.

The state is the reference's ``{"tm_last", "cm_last", "wkv", "len"}``, stacked
over layers, with ``len`` a Python int.  Each call returns a new state (the
recurrent parts in the activations' dtype, ``wkv`` in f32); the one it was
given is left as it was.  A serving engine steps every slot at once, so a
prefill also advances the other slots' state (ROADMAP §3 R3).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import (RWKVLayer, rwkv_layer_fwd, rwkv_layer_init,
                                    rwkv_layer_specs)
from repro_torch.models.transformer import LM, check_layers

STATE = ("tm_last", "cm_last", "wkv")


class RWKV(LM):
    """Embedding, ``layers`` (``RWKVLayer``), final norm, logits.  ``params``
    is the reference's tree with the layers as a list (or any iterable) of
    per-layer dicts."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(cfg, params)
        self.layers = nn.ModuleList(RWKVLayer(cfg, lp) for lp in params["layers"])
        check_layers(len(self.layers), cfg.n_layers)

    def tree(self) -> dict[str, Any]:
        return {**self._common_tree(), "layers": [lp.tree() for lp in self.layers]}

    def forward(self, tokens: torch.Tensor, state: dict | None = None, remat=None
                ) -> tuple[torch.Tensor, dict]:
        """-> (final-normed hidden states (B, S, D), the new state); each
        layer under ``remat`` (``layers.remat``)."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        st = state or init_state(self.cfg, x.shape[0], device=x.device)
        tm, cm = st["tm_last"].to(x.dtype), st["cm_last"].to(x.dtype)
        new = {k: [] for k in STATE}
        for i, lp in enumerate(self.layers):
            x, ns = L.remat(remat, rwkv_layer_fwd, self.cfg, lp, x,
                            {"tm_last": tm[i], "cm_last": cm[i], "wkv": st["wkv"][i]})
            for k in STATE:
                new[k].append(ns[k])
        new_state = {k: torch.stack(v) for k, v in new.items()}
        new_state["len"] = int(st["len"]) + tokens.shape[1]
        return self._finish(x), new_state

    def train_loss(self, batch: Mapping[str, torch.Tensor], remat=None) -> torch.Tensor:
        """The reference's ``train_loss``: the next-token loss from a zero state."""
        x, _ = self(batch["tokens"], remat=remat)
        return L.cross_entropy(self.logits(x), batch["labels"])

    def prefill(self, tokens: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        x, new_state = self(tokens, state)
        return self.logits(x[:, -1:]), new_state

    def decode_step(self, token: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        """token (B, 1).  The recurrent state is the whole 'cache': its size does
        not grow with the context."""
        x, new_state = self(token, state)
        return self.logits(x), new_state


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None,
         train: bool = False) -> RWKV:
    """Random weights with the reference's shapes and scales, drawn in f32 on
    ``device`` (the card unless given) one layer at a time; with ``train``
    kept in f32 to take gradients (``LM.trainable``)."""
    device = L.resolve_device(device)
    params = {"embed": L.embed_init(generator, cfg, device=device),
              "layers": (rwkv_layer_init(generator, cfg, device) for _ in range(cfg.n_layers)),
              "final_norm": L.oinit((cfg.d_model,), device)}
    return (RWKV.trainable if train else RWKV)(cfg, params)


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's logical specs of the param tree (layers stacked)."""
    return {"embed": L.embed_specs(cfg), "layers": ("stacked", rwkv_layer_specs(cfg)),
            "final_norm": (None,)}


def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    dtype = dtype or cfg.dtype
    device = L.resolve_device(device)
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    Lyr = cfg.n_layers
    return {"tm_last": torch.zeros((Lyr, batch, D), dtype=dtype, device=device),
            "cm_last": torch.zeros((Lyr, batch, D), dtype=dtype, device=device),
            "wkv": torch.zeros((Lyr, batch, H, hd, hd), dtype=torch.float32, device=device),
            "len": 0}


def state_specs(cfg: ModelConfig) -> dict:
    return {"tm_last": (None, "fsdp", None), "cm_last": (None, "fsdp", None),
            "wkv": (None, "fsdp", ("tp", cfg.n_heads), None, None), "len": ()}
